"""Mean of the worker's ``scene_timings.exec_s`` over the jobs completed in the window, in ms."""

from perfbench.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "exec_s")
