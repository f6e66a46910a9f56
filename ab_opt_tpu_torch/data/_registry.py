"""Dataset registry (the port's own copy of ``ab_opt_tpu/data/_registry.py``):
a dataset config's ``type`` names the function that builds the dataset
from the config and the transform pipeline its ``transform`` list
describes."""
from __future__ import annotations

from .transforms import get_transform

_DATASET_DICT = {}


def register_dataset(name: str):
    def decorator(fn):
        _DATASET_DICT[name] = fn
        return fn
    return decorator


def get_dataset(cfg):
    """Build a dataset from a config dict with 'type' + optional 'transform'."""
    transform = get_transform(cfg.get('transform'))
    return _DATASET_DICT[cfg['type']](cfg, transform)
