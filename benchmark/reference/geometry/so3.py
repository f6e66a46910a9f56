"""SO(3) exponential/log maps and rotation parameterizations.

Counterpart of ``ab_opt_tpu/geometry/so3.py``, same conventions (this
codebase's transposed-skew exp map, the conjugate quaternion algebra, the
clamped log map). "Planar" rotations are (..., 9) tensors holding the
row-major matrix entries, R9[..., 3*c + d] == R[..., c, d] — the layout the
GABlock kernel reads.
"""
from __future__ import annotations

import torch

from .vec import normalize_vector

_MIN_COS = -0.9999


def so3vec_to_skewsym(w):
    """Axis-angle vector (..., 3) -> skew-symmetric matrix (..., 3, 3)."""
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    rows = torch.stack([o, z, -y, -z, o, x, y, -x, o], dim=-1)
    return rows.reshape(w.shape[:-1] + (3, 3))


def skewsym_to_so3vec(S):
    """Skew-symmetric matrix (..., 3, 3) -> axis-angle vector (..., 3)."""
    return torch.stack([S[..., 1, 2], S[..., 2, 0], S[..., 0, 1]], dim=-1)


def exp_skewsym(S):
    """Rodrigues' formula: exp of a skew-symmetric matrix (..., 3, 3)."""
    w = skewsym_to_so3vec(S)
    x = torch.sqrt(torch.clamp(w.square().sum(-1), min=1e-16))
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand(S.shape)
    b = (torch.sin(x) + 1e-8) / (x + 1e-8)
    c = (1.0 - torch.cos(x) + 1e-8) / (x * x + 2e-8)
    return eye + b[..., None, None] * S + c[..., None, None] * (S @ S)


def log_rotation(R):
    """Matrix log of a rotation (..., 3, 3) -> skew-symmetric (..., 3, 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, _MIN_COS, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=1e-12))
    coef = (theta + 1e-8) / (2.0 * sin_theta + 2e-8)
    return coef[..., None, None] * (R - R.transpose(-1, -2))


def so3vec_to_rotation(w):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    return exp_skewsym(so3vec_to_skewsym(w))


def rotation_to_so3vec(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    return skewsym_to_so3vec(log_rotation(R))


# Planar rotations: (..., 9) row-major entries.


def planar_to_matrix(R9):
    """(..., 9) -> (..., 3, 3)."""
    return R9.reshape(R9.shape[:-1] + (3, 3))


def so3vec_to_rotation_planar(w):
    """Axis-angle (..., 3) -> planar rotation (..., 9); Rodrigues with S^2
    expanded as w w^T - |w|^2 I."""
    x, y, z = w.unbind(-1)
    n2 = x * x + y * y + z * z
    theta = torch.sqrt(torch.clamp(n2, min=1e-16))
    b = (torch.sin(theta) + 1e-8) / (theta + 1e-8)
    c = (1.0 - torch.cos(theta) + 1e-8) / (n2 + 2e-8)
    return torch.stack([
        1.0 + c * (x * x - n2), b * z + c * (x * y), -b * y + c * (x * z),
        -b * z + c * (x * y), 1.0 + c * (y * y - n2), b * x + c * (y * z),
        b * y + c * (x * z), -b * x + c * (y * z), 1.0 + c * (z * z - n2),
    ], dim=-1)


def planar_rotation_to_so3vec(R9):
    """Planar rotation (..., 9) -> axis-angle (..., 3) (log map)."""
    r = R9.unbind(-1)
    trace = r[0] + r[4] + r[8]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, _MIN_COS, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=1e-12))
    coef = (theta + 1e-8) / (2.0 * sin_theta + 2e-8)
    return torch.stack([coef * (r[5] - r[7]), coef * (r[6] - r[2]),
                        coef * (r[1] - r[3])], dim=-1)


def quaternion_1ijk_to_rotation_planar(v):
    """(1 + bi + cj + dk) -> planar rotation (..., 9)."""
    b, c, d = v.unbind(-1)
    s = torch.sqrt(1.0 + b * b + c * c + d * d)
    a, b, c, d = 1.0 / s, b / s, c / s, d / s
    return torch.stack([
        a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
        2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d,
    ], dim=-1)


def planar_compose(A9, B9):
    """Planar rotation product A @ B."""
    a, b = A9.unbind(-1), B9.unbind(-1)
    return torch.stack([
        a[3 * c] * b[d] + a[3 * c + 1] * b[3 + d] + a[3 * c + 2] * b[6 + d]
        for c in range(3) for d in range(3)], dim=-1)


def planar_apply_to_vector(R9, p):
    """R @ p for planar R (..., 9) and vectors (..., 3)."""
    r = R9.unbind(-1)
    px, py, pz = p.unbind(-1)
    return torch.stack([r[3 * c] * px + r[3 * c + 1] * py + r[3 * c + 2] * pz
                        for c in range(3)], dim=-1)


def quaternion_to_rotation_matrix(q):
    """Quaternion (..., 4) [w, x, y, z], normalized here -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, i, j, k = q.unbind(-1)
    rows = torch.stack([
        1 - 2 * (j * j + k * k), 2 * (i * j - k * r), 2 * (i * k + j * r),
        2 * (i * j + k * r), 1 - 2 * (i * i + k * k), 2 * (j * k - i * r),
        2 * (i * k - j * r), 2 * (j * k + i * r), 1 - 2 * (i * i + j * j),
    ], dim=-1)
    return rows.reshape(q.shape[:-1] + (3, 3))


def so3vec_to_quaternion(w):
    """Axis-angle (..., 3) -> unit quaternion (..., 4) [w, x, y, z], in the
    conjugate convention matching :func:`so3vec_to_rotation`."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    axis = w / (theta + 1e-12)
    half = 0.5 * theta
    return torch.cat([torch.cos(half), -torch.sin(half) * axis], dim=-1)


def quaternion_mul(a, b):
    """Hamilton product of quaternions (..., 4) [w, x, y, z]."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_to_so3vec(q):
    """Unit quaternion (..., 4) -> axis-angle (..., 3), theta in [0, pi]."""
    q = torch.where(q[..., :1] < 0, -q, q)
    vec = -q[..., 1:]
    n = torch.linalg.norm(vec, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(n, q[..., :1])
    return vec / (n + 1e-12) * theta


def random_uniform_so3(shape, generator=None, device=None, normal=None):
    """Uniform random rotations as so3 vectors, shape ``shape + (3,)``.

    ``normal``: optional (shape + (4,)) standard-normal draws; otherwise
    drawn from ``generator``.
    """
    if normal is None:
        normal = torch.randn(tuple(shape) + (4,), generator=generator,
                             device=device)
    q = normalize_vector(normal)
    return rotation_to_so3vec(quaternion_to_rotation_matrix(q))
