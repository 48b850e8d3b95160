"""The model's operations for every window of every job completed in the
traced window (2 x multiply-adds, counted from the configuration's shapes),
over the window's seconds and the policy's peak (TF32 for float32)."""

from perfbench.harness import work
from perfbench.harness.readers import peak_flops


def read(run):
    if run.trace is None or not run.jobs:
        return None
    flops = len(run.jobs) * run.windows_per_job * work.window_flops(run.arch)
    return 100.0 * flops / (run.trace["window_us"] * 1e-6) / peak_flops(run)
