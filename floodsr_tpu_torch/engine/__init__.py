from floodsr_tpu_torch.engine.base import EngineBase, ModelIOContract
from floodsr_tpu_torch.engine.torch_engine import EngineTorch

__all__ = ["EngineBase", "ModelIOContract", "EngineTorch"]
