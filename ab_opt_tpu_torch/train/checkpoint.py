"""Checkpoints that carry their config (counterpart of
``ab_opt_tpu/train/checkpoint.py``): one ``torch.save`` payload
``{'config', 'model', 'optimizer', 'iteration', 'extra'}``, written to a
temporary file and renamed into place, so a reader never sees a partial
checkpoint. :func:`read_weights` also reads the JAX package's checkpoints
(a pickle of numpy trees) without importing JAX, and
:func:`read_reference_checkpoint` the reference's (``torch.save`` of
``{config, model, optimizer, scheduler, iteration}``, its config an
``easydict`` or ``dynamic_yaml`` object) without those packages."""
from __future__ import annotations

import builtins
import collections
import os
import pickle
import types
import zipfile
from typing import Any, Dict, Optional

import torch

CONVERTER = 'python -m ab_opt_tpu_torch.runners.convert_checkpoint SRC DST'
_PORT_KEYS = frozenset(('config', 'model', 'optimizer', 'iteration', 'extra'))


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


def _not_ours(path: str) -> str:
    return (f'{path} is neither a port checkpoint nor a JAX one; a '
            f'reference torch checkpoint converts with: {CONVERTER}')


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of :func:`save_checkpoint`, tensors on the CPU. Any
    other ``torch.save`` file (a reference checkpoint) raises a ValueError
    naming the converter."""
    try:
        saved = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(_not_ours(path)) from e
    if not (isinstance(saved, dict) and _PORT_KEYS <= saved.keys()):
        raise ValueError(_not_ours(path))
    return saved


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
    """``{'config', 'state_dict', 'iteration'}`` of a port checkpoint or a
    JAX one (its params go through the weight bridge of its config's model
    type: ``diffab`` when the config names none, as the JAX package reads
    it). Any other file raises a ValueError naming the converter."""
    from ..utils.convert import (diff_gnn_params_to_state_dict,
                                 params_to_state_dict)
    if is_port_checkpoint(path):
        saved = load_checkpoint(path)
        return {'config': saved['config'], 'state_dict': saved['model'],
                'iteration': saved['iteration']}
    with open(path, 'rb') as f:
        saved = _JaxCheckpointUnpickler(f).load()
    if not (isinstance(saved, dict) and 'params' in saved):
        raise ValueError(_not_ours(path))
    model_type = ((saved['config'] or {}).get('model') or {}).get(
        'type', 'diffab')
    bridges = {'diffab': params_to_state_dict,
               'diff_gnn': diff_gnn_params_to_state_dict}
    if model_type not in bridges:
        raise ValueError(f'{path}: no weight bridge for model type '
                         f'{model_type!r} (the port reads {sorted(bridges)})')
    return {'config': saved['config'],
            'state_dict': bridges[model_type](saved['params']),
            'iteration': saved.get('iteration', 0)}


# --------------------------------------------------------------------------- #
# Reference checkpoints, read without easydict or dynamic_yaml
# --------------------------------------------------------------------------- #


class _YamlDict(dict):
    """Stands in for a ``dynamic_yaml`` mapping, whose pickled form is not
    known here: it takes its items as pickled and, when it has none, the
    first mapping among its constructor arguments or its attributes (a
    wrapper may keep its data in one); other attributes are dropped."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self._take(list(args) + list(kwargs.values()))

    def _take(self, candidates):
        if not self:
            mapping = next((c for c in candidates if isinstance(c, dict)),
                           None)
            if mapping is not None:
                self.update(mapping)

    def __setstate__(self, state):
        if isinstance(state, tuple):          # (__dict__, __slots__ state)
            state = {k: v for part in state if isinstance(part, dict)
                     for k, v in part.items()}
        if isinstance(state, dict):
            self._take(list(state.values()))


class _YamlList(list):
    """Stands in for a ``dynamic_yaml`` sequence (see :class:`_YamlDict`)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        seq = next((a for a in args if isinstance(a, (list, tuple))), ())
        self.extend(seq)

    def __setstate__(self, state):
        if isinstance(state, tuple):
            state = {k: v for part in state if isinstance(part, dict)
                     for k, v in part.items()}
        if not self and isinstance(state, dict):
            self.extend(next((v for v in state.values()
                              if isinstance(v, (list, tuple))), ()))


_BUILTINS = frozenset(('dict', 'list', 'tuple', 'set', 'frozenset', 'slice',
                       'complex', 'bytearray', 'bytes', 'int', 'float',
                       'str', 'bool'))


def _allowed_global(module: str, name: str):
    """The globals a reference checkpoint may name besides its config
    classes: torch's tensor-rebuild functions, dtypes, sizes and devices,
    and the builtin and ``collections`` containers. None for any other."""
    if module == 'torch._utils' and name.startswith('_rebuild_'):
        return getattr(torch._utils, name, None)
    if (module, name) == ('torch._tensor', '_rebuild_from_type_v2'):
        return torch._tensor._rebuild_from_type_v2
    if (module, name) == ('torch.nn.parameter', 'Parameter'):
        return torch.nn.Parameter
    if module == 'torch':
        obj = getattr(torch, name, None)
        if name in ('Size', 'device') or isinstance(obj, torch.dtype):
            return obj
    if module == 'collections' and name in ('OrderedDict', 'defaultdict'):
        return getattr(collections, name)
    if module in ('builtins', '__builtin__') and name in _BUILTINS:
        return getattr(builtins, name)
    return None


class _ReferenceUnpickler(pickle.Unpickler):
    """Reads a reference checkpoint without its config packages:
    ``easydict`` classes become the port's ConfigDict, ``dynamic_yaml``
    ones :class:`_YamlDict` / :class:`_YamlList`; tensors, containers and
    the globals of :func:`_allowed_global` pass; every other global is
    refused, since a pickle may otherwise run any code."""

    def find_class(self, module, name):
        from ..utils.config import ConfigDict
        top = module.split('.')[0]
        if top == 'easydict':
            return ConfigDict
        if top == 'dynamic_yaml':
            return _YamlList if 'List' in name else _YamlDict
        obj = _allowed_global(module, name)
        if obj is None:
            raise pickle.UnpicklingError(
                f'the checkpoint names {module}.{name}, which a reference '
                'checkpoint is not read with (only tensors, containers and '
                'its config classes are)')
        return obj


# torch.load's pickle_module: the zip format unpickles its records with
# .Unpickler, the legacy format also calls .load.
_REFERENCE_PICKLE = types.ModuleType('ab_opt_tpu_torch_reference_pickle')
_REFERENCE_PICKLE.Unpickler = _ReferenceUnpickler
_REFERENCE_PICKLE.load = lambda f, **kw: _ReferenceUnpickler(f, **kw).load()


def _holds_yaml(cfg) -> bool:
    if isinstance(cfg, (_YamlDict, _YamlList)):
        return True
    values = cfg.values() if isinstance(cfg, dict) else (
        cfg if isinstance(cfg, (list, tuple)) else ())
    return any(_holds_yaml(v) for v in values)


def _plain_config(cfg):
    """A config object -> plain dicts and lists, recursively (the JAX
    script's ``torch_cfg_to_dict``)."""
    if hasattr(cfg, 'items'):
        return {k: _plain_config(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [_plain_config(v) for v in cfg]
    return cfg


def read_reference_checkpoint(path: str) -> Dict:
    """``{'config', 'state_dict', 'iteration'}`` of a reference torch
    checkpoint, read as ``scripts/convert_checkpoint.py`` reads it (the
    state dict is ``saved['model']`` when there is one, else the whole
    file), its config as plain dicts, without ``easydict`` or
    ``dynamic_yaml`` installed. A ``dynamic_yaml`` config's ``"{a.b}"``
    strings are resolved as ``utils/config.py::load_config`` resolves
    them. The optimizer and scheduler states are not read further."""
    from ..utils.config import ConfigDict, _interpolate
    saved = torch.load(path, map_location='cpu', weights_only=False,
                       pickle_module=_REFERENCE_PICKLE)
    if not isinstance(saved, dict):
        raise ValueError(f'{path}: a reference checkpoint is a dict, not '
                         f'{type(saved).__name__}')
    config = _plain_config(saved.get('config') or {})
    if _holds_yaml(saved.get('config')):
        config = _plain_config(_interpolate(config, ConfigDict.wrap(config)))
    return {'config': config,
            'state_dict': saved['model'] if 'model' in saved else saved,
            'iteration': int(saved.get('iteration', 0))}
