"""Model registry (counterpart of ``ab_opt_tpu/models/_base.py``): a config
dict's ``type`` names the model class, which takes the rest of the dict."""
from __future__ import annotations

_MODEL_DICT = {}


def register_model(name: str):
    def decorator(cls):
        _MODEL_DICT[name] = cls
        return cls
    return decorator


def get_model(cfg):
    """Build a model from a config dict with a 'type' key. Raises KeyError
    naming the type when no model of that type is registered."""
    cfg = dict(cfg)
    model_type = cfg.pop('type')
    if model_type not in _MODEL_DICT:
        raise KeyError(f'model type {model_type!r} is not registered in the '
                       f'port (registered: {sorted(_MODEL_DICT)})')
    return _MODEL_DICT[model_type](cfg)
