"""Training: AdamW on fp32 masters, the train step, npz checkpoints.

Port of ``repro.training``."""

from .optimizer import OptConfig, apply_updates, init_opt_state
from .train_step import loss_and_grads, make_train_step

__all__ = ["OptConfig", "apply_updates", "init_opt_state",
           "loss_and_grads", "make_train_step"]
