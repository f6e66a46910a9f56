"""Batch collation with length buckets, pasting a patch back into its
complex, and batch transfer to a device (counterpart of
``ab_opt_tpu/data/collate.py``; the host side is the same numpy code).

Lengths round up to a bucket so that crops of different complexes share
padded shapes (K1 takes L a multiple of 16 up to 256: every bucket up to
256 is one).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_PAD_VALUES = {'aa': 21, 'chain_id': ' ', 'icode': ' '}
DEFAULT_NO_PADDING = {'origin', 'patch_idx'}
DEFAULT_BUCKETS = (32, 48, 64, 96, 128, 160, 192, 256, 320, 384, 512)


def pad_to_length(x, n, value=0):
    if isinstance(x, np.ndarray) and x.ndim >= 1:
        if x.shape[0] >= n:
            return x[:n]
        pad = np.full((n - x.shape[0],) + x.shape[1:], value, dtype=x.dtype)
        return np.concatenate([x, pad], axis=0)
    if isinstance(x, list):
        return x + [value] * (n - len(x))
    return x


class PaddingCollate:
    def __init__(self, length_ref_key='aa', pad_values=None, no_padding=None,
                 buckets: Optional[Sequence[int]] = DEFAULT_BUCKETS,
                 eight: bool = True):
        self.length_ref_key = length_ref_key
        self.pad_values = dict(DEFAULT_PAD_VALUES if pad_values is None
                               else pad_values)
        self.no_padding = set(DEFAULT_NO_PADDING if no_padding is None
                              else no_padding)
        self.buckets = tuple(buckets) if buckets else None
        self.eight = eight

    def _target_length(self, max_length: int) -> int:
        if self.buckets is not None:
            for b in self.buckets:
                if max_length <= b:
                    return b
        if self.eight:
            return int(math.ceil(max_length / 8) * 8)
        return max_length

    def __call__(self, data_list: List[Dict]) -> Dict:
        max_length = max(d[self.length_ref_key].shape[0] for d in data_list)
        n = self._target_length(max_length)
        keys = set(data_list[0].keys())
        for d in data_list[1:]:
            keys &= set(d.keys())

        out: Dict[str, list] = {}
        masks = []
        for d in data_list:
            length = d[self.length_ref_key].shape[0]
            masks.append(np.arange(n) < length)
            for k in keys:
                v = d[k]
                if k not in self.no_padding:
                    v = pad_to_length(v, n, self.pad_values.get(k, 0))
                out.setdefault(k, []).append(v)

        batch = {}
        for k, vs in out.items():
            if isinstance(vs[0], np.ndarray):
                # no_padding entries (origin, patch_idx) may be ragged when
                # crop sizes differ across the batch: kept as a list
                # (host-side bookkeeping, never sent to the device).
                shapes = {v.shape for v in vs}
                batch[k] = np.stack(vs) if len(shapes) == 1 else vs
            else:
                batch[k] = vs
        batch['mask'] = np.stack(masks)
        return batch


def apply_patch_to_tensor(x_full: np.ndarray, x_patch: np.ndarray,
                          patch_idx: np.ndarray) -> np.ndarray:
    """Paste patch rows back into the full complex."""
    x_full = np.array(x_full, copy=True)
    x_full[patch_idx] = x_patch
    return x_full


def to_device_batch(batch: Dict, device='cpu') -> Dict:
    """Keep the array-valued entries, as tensors on ``device``: integers as
    int64, booleans as bool, floats as float32. Other entries (host-side
    bookkeeping such as chain ids) are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        elif not torch.is_tensor(v):
            continue
        if v.dtype.is_floating_point:
            v = v.float()
        elif v.dtype != torch.bool:
            v = v.long()
        out[k] = v.to(device)
    return out
