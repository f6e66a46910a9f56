"""Models (counterpart of ``ab_opt_tpu/models``): the registry, the DiffAb
model, registered as ``'diffab'``, and the AbDesign graph model, registered
as ``'diff_gnn'``."""
from ._base import get_model, register_model
from .diff_gnn import DiffGNN, DiffGNNConfig
from .diffab import DiffAb, DiffAbConfig, DiffAbNet

__all__ = ['DiffAb', 'DiffAbConfig', 'DiffAbNet', 'DiffGNN', 'DiffGNNConfig',
           'get_model', 'register_model']
