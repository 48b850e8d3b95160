"""K3 (``relax_step``, ``floodsr_tpu_torch/csrc/relax_step.cu``): the least
time of its launches in the traced window, over its device time there.

The launches are the counter ``k3_launches`` of every completed job's record
(each least-cost solve's span carries those it made); the least time of one
is the bytes it must move at 3.35 TB/s
(``families/costgrow.py::relax_bytes_per_launch``: three float32 reads and
two writes a cell, whatever number of sweeps one launch makes). The device
time sums the kernels named ``relax_step_kernel``. None where a job's record
lacks the counter or the trace has no such kernel."""

from perfbench.harness import spec
from perfbench.harness.readers import device_seconds
from perfbench.harness.spans import record

KERNELS = ("relax_step_kernel",)


def read(run):
    if run.trace is None or not run.jobs:
        return None
    launches = [(record(r) or {}).get("counters", {}).get("k3_launches") for _, r in run.jobs]
    if None in launches:
        return None
    spent = device_seconds(run, KERNELS)
    if spent <= 0:
        return None
    family = spec.family(run.cfg)
    least = sum(launches) * family.relax_bytes_per_launch(run.geometry["hr_shape"])
    return 100.0 * least / family.HBM_BYTES_PER_S / spent
