"""Checkpoints that carry their config (counterpart of
``ab_opt_tpu/train/checkpoint.py``): one ``torch.save`` payload
``{'config', 'model', 'optimizer', 'iteration', 'extra'}``, written to a
temporary file and renamed into place, so a reader never sees a partial
checkpoint."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, *, config: Dict, model: Dict,
                    optimizer: Optional[Dict] = None, iteration: int = 0,
                    extra: Optional[Dict] = None) -> str:
    """``model`` and ``optimizer`` are state dicts; ``config`` and
    ``extra`` plain Python values."""
    payload = {'config': config,
               'model': {k: v.detach().cpu() for k, v in model.items()},
               'optimizer': optimizer, 'iteration': int(iteration),
               'extra': extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of :func:`save_checkpoint`, tensors on the CPU."""
    return torch.load(path, map_location='cpu', weights_only=True)
