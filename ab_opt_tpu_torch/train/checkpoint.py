"""Checkpoints that carry their config (counterpart of
``ab_opt_tpu/train/checkpoint.py``): one ``torch.save`` payload
``{'config', 'model', 'optimizer', 'iteration', 'extra'}``, written to a
temporary file and renamed into place, so a reader never sees a partial
checkpoint. :func:`read_weights` also reads the JAX package's checkpoints
(a pickle of numpy trees) without importing JAX."""
from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, *, config: Dict, model: Dict,
                    optimizer: Optional[Dict] = None, iteration: int = 0,
                    extra: Optional[Dict] = None) -> str:
    """``model`` and ``optimizer`` are state dicts; ``config`` and
    ``extra`` Python values, stored as plain dicts and lists (a
    ``ConfigDict`` becomes a dict), which :func:`load_checkpoint` reads
    with ``weights_only``."""
    payload = {'config': _plain(config),
               'model': {k: v.detach().cpu() for k, v in model.items()},
               'optimizer': optimizer, 'iteration': int(iteration),
               'extra': _plain(extra or {})}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of :func:`save_checkpoint`, tensors on the CPU."""
    return torch.load(path, map_location='cpu', weights_only=True)


def is_port_checkpoint(path: str) -> bool:
    """A port checkpoint is a torch.save zip; a JAX one a plain pickle."""
    return zipfile.is_zipfile(path)


def require_resumable(path: str):
    """Raise unless ``path`` is a port checkpoint: a JAX checkpoint's optax
    state has no counterpart here, so only its weights can be taken."""
    if not is_port_checkpoint(path):
        raise ValueError(
            f'{path} is a JAX checkpoint: its optimizer state cannot be '
            'resumed here; start from its weights with --finetune')


class _Opaque(tuple):
    """Stands in, when a JAX checkpoint is read, for a class of the JAX
    stack (optimizer states); the port never reads those parts."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


class _JaxCheckpointUnpickler(pickle.Unpickler):
    """Reads a JAX checkpoint (a pickle of numpy trees) without importing
    JAX or the JAX package: its ConfigDict becomes the port's, and the
    JAX stack's own classes become :class:`_Opaque`."""

    def find_class(self, module, name):
        from ..utils.config import ConfigDict
        top = module.split('.')[0]
        if module == 'ab_opt_tpu.utils.config' and name == 'ConfigDict':
            return ConfigDict
        if top == 'ab_opt_tpu':
            raise pickle.UnpicklingError(
                f'the checkpoint holds {module}.{name}, which the port '
                'cannot read')
        if top in ('jax', 'jaxlib', 'flax', 'optax', 'chex'):
            return _Opaque
        return super().find_class(module, name)


def read_weights(path: str) -> Dict:
    """``{'config', 'state_dict'}`` of a port checkpoint or a JAX one (its
    params go through the weight bridge)."""
    from ..utils.convert import params_to_state_dict
    if is_port_checkpoint(path):
        saved = load_checkpoint(path)
        return {'config': saved['config'], 'state_dict': saved['model']}
    with open(path, 'rb') as f:
        saved = _JaxCheckpointUnpickler(f).load()
    return {'config': saved['config'],
            'state_dict': params_to_state_dict(saved['params'])}
