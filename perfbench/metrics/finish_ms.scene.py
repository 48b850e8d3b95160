"""Mean of the worker's ``scene_timings.finish_s`` over the jobs completed in the window, in ms."""

from perfbench.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "finish_s")
