"""Training: AdamW through the fused multi-strided kernel, and the train
step (loss → backward → AdamW)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_step
from repro_torch.train.trainstep import init_state, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_step", "init_state",
           "make_train_step"]
