"""A CostGrow job's output (span ``worker.write``: the float32 raster's
nodata fill, its LZW encode and the file write), mean over the window's
completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def read(run):
    return mean_ms(run, lambda r: span_ms(r, "worker.write"))
