"""The output's LZW encode (every span ``sink.encode`` of the finish's row
sink, summed a job), mean over the window's completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def read(run):
    return mean_ms(run, lambda r: span_ms(r, "sink.encode"))
