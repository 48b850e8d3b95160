from floodsr_tpu_torch.engine.base import EngineBase, ModelIOContract
from floodsr_tpu_torch.engine.torch_engine import EngineTorch
from floodsr_tpu_torch.engine.providers import doctor_info, get_io_info, get_torch_info

__all__ = ["EngineBase", "ModelIOContract", "EngineTorch", "get_torch_info", "get_io_info", "doctor_info"]
