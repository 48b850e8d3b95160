"""K1 (``hr_tail``, ``floodsr_tpu_torch/csrc/hr_tail.cu``): the least time its
work in the traced window could take, over its device time there. The least
time is the larger of its operations at the policy's peak and its bytes at
3.35 TB/s, counted from the configuration's shapes for every window of every
completed job; the device time sums every kernel of K1's routes."""

from perfbench.harness import work
from perfbench.harness.readers import device_seconds, peak_flops

KERNELS = (
    "conv_tc_", "conv_bf16_kernel", "conv_bf16_head_kernel", "bf16_prepass_kernel",
    "bf16_band_kernel", "affine_relu_conv3x3_kernel", "conv1x1_kernel",
)


def read(run):
    if run.trace is None or not run.jobs:
        return None
    spent = device_seconds(run, KERNELS)
    if spent <= 0:
        return None
    windows = len(run.jobs) * run.windows_per_job
    least = windows * max(work.hr_tail_flops(run.arch) / peak_flops(run),
                          work.hr_tail_bytes(run.arch) / work.HBM_BYTES_PER_S)
    return 100.0 * least / spent
