"""Small vector helpers (counterpart of ``ab_opt_tpu/geometry/vec.py``)."""
from __future__ import annotations

import torch


def safe_norm(x, dim=-1, keepdim=False, eps=1e-8, sqrt=True):
    """Norm with a floor on the squared sum so gradients stay finite at 0."""
    sq = torch.clamp(x.square().sum(dim, keepdim=keepdim), min=eps)
    return torch.sqrt(sq) if sqrt else sq


def normalize_vector(v, dim=-1, eps=1e-6):
    """v / (sqrt(|v|^2 + eps^2) + eps): zero vectors map to zero."""
    n = torch.sqrt(v.square().sum(dim, keepdim=True) + eps * eps)
    return v / (n + eps)


def project_v2v(v, e, dim=-1):
    """Project vector ``v`` onto unit vector ``e``."""
    return (e * v).sum(dim, keepdim=True) * e


def pairwise_distances(x, y=None, return_v=False):
    """All-pairs distances. x: (..., N, d), y: (..., M, d) -> (..., N, M)."""
    if y is None:
        y = x
    v = x[..., :, None, :] - y[..., None, :, :]
    d = safe_norm(v, dim=-1)
    return (d, v) if return_v else d


def angstrom_to_nm(x):
    return x / 10.0
