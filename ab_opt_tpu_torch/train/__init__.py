"""Training (counterpart of ``ab_opt_tpu/train``): the trainer loop,
optimizers, schedulers, checkpoints and the sampling-in-the-loop eval."""
from .checkpoint import load_checkpoint, read_weights, save_checkpoint
from .trainer import (DIFFAB_TRAIN_CONFIG, ExpScheduler, PlateauScheduler,
                      Trainer, build_optimizer, build_scheduler)
from .sampling_eval import BestCheckpointTracker, evaluate_samples

__all__ = [k for k in dir() if not k.startswith('_')]
