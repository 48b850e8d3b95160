"""Training for the port: data, train/eval steps and checkpoints (``trainer``)."""

from floodsr_tpu_torch.train.trainer import (
    TrainConfig,
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    restore_train_state,
    save_train_state,
)
from floodsr_tpu_torch.train.data import PatchDataset, split_indices

__all__ = [
    "TrainConfig",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_eval_step",
    "save_train_state",
    "restore_train_state",
    "PatchDataset",
    "split_indices",
]
