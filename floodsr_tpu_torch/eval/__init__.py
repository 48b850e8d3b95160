from floodsr_tpu_torch.eval.metrics import compute_depth_error_metrics

__all__ = ["compute_depth_error_metrics"]
