"""HR megapixels written per second: every output pixel of every job that
completed in the window, over the window's seconds (host clock)."""

from perfbench.harness.readers import completed_mp


def read(run):
    return completed_mp(run) / run.window_s if run.jobs else None
