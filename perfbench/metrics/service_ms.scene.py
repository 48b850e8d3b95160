"""The service's own time a job (``floodsr_tpu_torch/serve.py``): span
``service.job`` less its ``worker.run`` (hand-off to the device thread, fetch
resolution, prefetch start, the result's conversion), mean over the window's
completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def read(run):
    return mean_ms(run, lambda r: span_ms(r, "service.job", self_time=True))
