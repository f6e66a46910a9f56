"""Small tensor helpers (the port's copy of ``ab_opt_tpu/nn/tensor_utils.py``,
after the reference's OpenFold-derived ``tensor_utils.py``)."""
from __future__ import annotations

import torch


def permute_final_dims(t: torch.Tensor, inds) -> torch.Tensor:
    """Permute the last ``len(inds)`` dims by ``inds``."""
    zero_index = -1 * len(inds)
    first = list(range(t.dim() + zero_index))
    return t.permute(first + [t.dim() + zero_index + i for i in inds])


def flatten_final_dims(t: torch.Tensor, num_dims: int) -> torch.Tensor:
    return t.reshape(t.shape[:-num_dims] + (-1,))


def masked_mean(mask, value, axis, eps: float = 1e-10) -> torch.Tensor:
    mask = torch.broadcast_to(mask, value.shape).to(value.dtype)
    return (mask * value).sum(axis) / (eps + mask.sum(axis))
