"""Utilities: the weight bridge, benchmark fixtures, the config loader and
the profiling helpers."""
from .config import ConfigDict, load_config
from .profiling import profile_trace, recorded, seed_all, span

__all__ = ['ConfigDict', 'load_config', 'profile_trace', 'recorded',
           'seed_all', 'span']
