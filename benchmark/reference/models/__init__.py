"""The models of the plain reference."""
from .diff_gnn import DiffGNN, DiffGNNConfig
from .diffab import DiffAb, DiffAbConfig

__all__ = [k for k in dir() if not k.startswith('_')]
