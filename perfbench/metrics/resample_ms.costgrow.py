"""CostGrow's phase 01 (span ``costgrow.resample``: the nodata masks, the
bilinear warp of the LR WSE onto the DEM grid and the nearest-neighbour
validity mask), mean over the window's completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def read(run):
    return mean_ms(run, lambda r: span_ms(r, "costgrow.resample"))
