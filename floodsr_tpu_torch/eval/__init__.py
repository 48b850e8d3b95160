from floodsr_tpu_torch.eval.metrics import compute_depth_error_metrics, depth_metrics_torch

__all__ = ["compute_depth_error_metrics", "depth_metrics_torch"]
