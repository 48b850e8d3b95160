"""CostGrow's solves (spans ``solve.*``: the neutral fill, the anchor
distance and the penalised fill, each a K3 wavefront with its host checks,
and the connectivity filter), summed a job, mean over the window's completed
jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms

SOLVES = ("solve.neutral_fill", "solve.anchor_distance", "solve.penalized_fill",
          "solve.components")


def _ms(result):
    parts = [span_ms(result, name) for name in SOLVES]
    return None if None in parts else sum(parts)


def read(run):
    return mean_ms(run, _ms)
