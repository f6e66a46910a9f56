"""Diffusion schedules and transitions in PyTorch (counterpart of
``ab_opt_tpu/diffusion``)."""
from .igso3 import IGSO3Tables, build_igso3_tables, sample_igso3_vector
from .schedule import VarianceSchedule, broadcast_coef
from .transitions import (PositionTransition, RotationTransition,
                          SequenceTransition, clamped_one_hot,
                          gumbel_noise)

__all__ = [k for k in dir() if not k.startswith('_')]
