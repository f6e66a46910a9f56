"""Rigid frames and local/global coordinate maps (counterpart of
``ab_opt_tpu/geometry/frames.py``). R (..., 3, 3) holds the basis vectors
as columns; point clouds attach extra axes before the coordinate axis."""
from __future__ import annotations

import torch

from .vec import normalize_vector, project_v2v


def construct_3d_basis(center, p1, p2):
    """Orthonormal basis from three points (typically CA, C, N): e1 toward
    p1, e2 the Gram-Schmidt complement toward p2, e3 = e1 x e2."""
    e1 = normalize_vector(p1 - center)
    v2 = p2 - center
    e2 = normalize_vector(v2 - project_v2v(v2, e1))
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def _flatten_points(p, batch_ndim):
    return p.reshape(p.shape[:batch_ndim] + (-1, 3)), p.shape


def local_to_global(R, t, p):
    """q = R p + t. R: (..., 3, 3), t: (..., 3), p: (..., K..., 3)."""
    p_flat, shape = _flatten_points(p, R.dim() - 2)
    q = torch.einsum('...ij,...kj->...ki', R, p_flat) + t[..., None, :]
    return q.reshape(shape)


def global_to_local(R, t, q):
    """p = R^T (q - t). Inverse of :func:`local_to_global`."""
    q_flat, shape = _flatten_points(q, R.dim() - 2)
    p = torch.einsum('...ji,...kj->...ki', R, q_flat - t[..., None, :])
    return p.reshape(shape)


def compose_rotation_and_translation(R1, t1, R2, t2):
    """Apply (R2, t2) inside frame (R1, t1): R' = R1 R2, t' = R1 t2 + t1."""
    return R1 @ R2, torch.einsum('...ij,...j->...i', R1, t2) + t1
