"""The output's writes: every span ``sink.write`` (encoded strips to the
file) and ``worker.close`` (the IFD, the file's close), summed a job, mean
over the window's completed jobs, in ms."""

from perfbench.harness.spans import mean_ms, span_ms


def _write_ms(result):
    parts = [span_ms(result, "sink.write"), span_ms(result, "worker.close")]
    return None if None in parts else sum(parts)


def read(run):
    return mean_ms(run, _write_ms)
