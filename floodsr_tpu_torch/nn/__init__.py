from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig, hr_tail_eligible

__all__ = ["ResUNet", "ResUNetConfig", "hr_tail_eligible"]
