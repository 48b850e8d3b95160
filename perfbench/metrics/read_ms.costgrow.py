"""A CostGrow job's read of its inputs (span ``read``: the LR WSE's and the
DEM's GeoTIFF decode, ``read.wse`` and ``read.dem``), mean over the window's
completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def read(run):
    return mean_ms(run, lambda r: span_ms(r, "read"))
