"""Models (counterpart of ``ab_opt_tpu/models``): the registry and the
DiffAb model, registered as ``'diffab'``."""
from ._base import get_model, register_model
from .diffab import DiffAb, DiffAbConfig, DiffAbNet

__all__ = ['DiffAb', 'DiffAbConfig', 'DiffAbNet', 'get_model',
           'register_model']
