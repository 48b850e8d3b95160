"""The worker's prepare (span ``worker.prepare``: ``write_prepared_rasters``,
alignment of depth and DEM), mean over the window's completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def read(run):
    return mean_ms(run, lambda r: span_ms(r, "worker.prepare"))
