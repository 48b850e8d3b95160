"""Share of the traced window that no device-side profiler event covers."""

from perfbench.harness.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
