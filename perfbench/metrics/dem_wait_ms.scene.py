"""The wait of a job's read on the DEM prefetch in flight (span
``read.dem_join``; 0 in a job that joined none), mean over the window's
completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def read(run):
    return mean_ms(run, lambda r: span_ms(r, "read.dem_join"))
