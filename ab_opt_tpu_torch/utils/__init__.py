"""Utilities: the weight bridge, benchmark fixtures, the config loader and
the profiling helpers."""
from .config import ConfigDict, load_config
from .profiling import StepTimer, profile_trace, seed_all

__all__ = ['ConfigDict', 'load_config', 'StepTimer', 'profile_trace',
           'seed_all']
