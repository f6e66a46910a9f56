"""Small building blocks (counterpart of ``ab_opt_tpu/nn/layers.py``).

Modules keep float32 parameters and compute in a ``dtype`` of their own,
as flax's ``dtype`` argument does: :class:`Linear` casts input, weight and
bias to it, :class:`LayerNorm` always runs in float32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import DeviceCopies


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``; the output stays in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose output is cast to ``dtype``."""

    def __init__(self, num: int, dim: int, dtype=torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, idx):
        return super().forward(idx).to(self.compute_dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with the reference's parameter names
    (``gamma``, ``beta``); float32 math, eps inside the rsqrt."""

    def __init__(self, dim: int, eps: float = 1e-10):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


def mlp(in_dim: int, features, dtype=torch.float32) -> nn.Sequential:
    """Linear/ReLU stack: hidden widths ``features[:-1]``, linear last layer
    (Linear layers at even indices, as in the reference state dicts)."""
    layers = []
    for i, f in enumerate(features):
        layers.append(Linear(in_dim, f, dtype=dtype))
        if i < len(features) - 1:
            layers.append(nn.ReLU())
        in_dim = f
    return nn.Sequential(*layers)


def distance_to_bins_onehot(dist, dist_min: float, dist_max: float,
                            num_bins: int):
    """One-hot nearest bin over linspace(dist_min, dist_max, num_bins):
    dist (...,) -> (..., num_bins) float32 (the pRMSD target)."""
    offsets = torch.linspace(dist_min, dist_max, num_bins,
                             device=dist.device)
    idx = (dist[..., None].float() - offsets).abs().argmin(-1)
    return F.one_hot(idx, num_bins).to(torch.float32)


class AngularEncoding(nn.Module):
    """Multi-frequency sin/cos encoding of angles: per input dim
    [x, sin(x f_k)..., cos(x f_k)...] with f = [1..k, 1, 1/2, ..., 1/k]."""

    def __init__(self, num_funcs: int = 3):
        super().__init__()
        self.num_funcs = k = num_funcs
        self.copies = DeviceCopies({'funcs': [i + 1.0 for i in range(k)]
                                    + [1.0 / (i + 1) for i in range(k)]})

    def get_out_dim(self, in_dim: int) -> int:
        return in_dim * (1 + 2 * 2 * self.num_funcs)

    def forward(self, x):
        y = x[..., None] * self.copies('funcs', x.device, x.dtype)
        code = torch.cat([x[..., None], torch.sin(y), torch.cos(y)], dim=-1)
        return code.reshape(x.shape[:-1] + (-1,))


class PerResiduePredictor(nn.Module):
    """LayerNorm + 3-layer MLP confidence head; returns logits."""

    def __init__(self, in_dim: int, no_bins: int, c_hidden: int,
                 dtype=torch.float32):
        super().__init__()
        self.layer_norm = LayerNorm(in_dim)
        self.linear_1 = Linear(in_dim, c_hidden, dtype=dtype)
        self.linear_2 = Linear(c_hidden, c_hidden, dtype=dtype)
        self.linear_3 = Linear(c_hidden, no_bins, dtype=dtype)

    def forward(self, s):
        s = self.layer_norm(s)
        s = torch.relu(self.linear_1(s))
        s = torch.relu(self.linear_2(s))
        return self.linear_3(s)
