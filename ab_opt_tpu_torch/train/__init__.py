"""Training (counterpart of ``ab_opt_tpu/train``)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .trainer import (DIFFAB_TRAIN_CONFIG, ExpScheduler, PlateauScheduler,
                      Trainer, build_optimizer, build_scheduler)

__all__ = [k for k in dir() if not k.startswith('_')]
