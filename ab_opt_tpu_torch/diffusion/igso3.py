"""Tabulated isotropic Gaussian on SO(3) (IGSO3) angle sampler.

Counterpart of ``ab_opt_tpu/diffusion/igso3.py``: the same host-side numpy
table build (truncated character series, 8192 bins, 1024 terms; Gaussian
approximation for noise levels <= 0.1), and inverse-CDF sampling for one
noise level shared by the whole batch (the sampler's scalar-t path) or one
level per complex or residue (training's forward noising, which reads the
levels' rows from the tables' device copies).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import DeviceCopies


class IGSO3Tables(NamedTuple):
    stddevs: np.ndarray        # (S,) float32
    approx_flag: np.ndarray    # (S,) bool: Gaussian approximation
    cdf: torch.Tensor          # (S, B-1) float32 inclusive CDF over bins
    dx: float                  # bin width = pi / (B - 1)
    copies: DeviceCopies       # stddevs and approx_flag on t's devices

    def to(self, device) -> 'IGSO3Tables':
        return self._replace(cdf=self.cdf.to(device))


def _igso3_density_rows(x: np.ndarray, eps: np.ndarray,
                        num_iters: int) -> np.ndarray:
    """Series density for many noise levels at once, (S, B)."""
    x = np.asarray(x, np.float64)
    ell = np.arange(num_iters, dtype=np.float64)
    ratio = ((np.sin((ell[None, :] + 0.5) * x[:, None]) + 1e-6)
             / (np.sin(x / 2.0)[:, None] + 1e-6))
    weight = (1.0 - np.cos(x)) / np.pi
    coef = ((2 * ell[None, :] + 1)
            * np.exp(-ell[None, :] * (ell[None, :] + 1) * (eps[:, None] ** 2)))
    f = weight[None, :] * (coef @ ratio.T)
    return np.nan_to_num(f).clip(min=0.0)


def build_igso3_tables(stddevs, std_threshold: float = 0.1,
                       num_bins: int = 8192, num_iters: int = 1024) -> IGSO3Tables:
    """Precompute CDF tables for a list of noise levels (host-side)."""
    stddevs = np.asarray(stddevs, np.float64)
    x = np.linspace(0.0, math.pi, num_bins)
    cdfs = np.zeros((len(stddevs), num_bins - 1), np.float64)
    series_rows = np.flatnonzero(stddevs > std_threshold)
    if len(series_rows):
        ys = _igso3_density_rows(x, stddevs[series_rows], num_iters)
        w = ys[:, :-1] + 1e-30
        cdfs[series_rows] = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
    gauss = stddevs <= std_threshold
    cdfs[gauss] = np.linspace(1.0 / (num_bins - 1), 1.0, num_bins - 1)
    per_level = dict(stddevs=stddevs.astype(np.float32), approx_flag=gauss)
    return IGSO3Tables(
        **per_level,
        cdf=torch.as_tensor(cdfs.astype(np.float32)),
        dx=math.pi / (num_bins - 1),
        copies=DeviceCopies(per_level),
    )


def sample_igso3_angle(tables: IGSO3Tables, t, shape, *, u=None,
                       frac=None, gauss=None, generator=None, device=None):
    """Angles in [0, pi), one per element of ``shape``. ``t`` is the noise
    level: a Python int shared by all elements (the sampler's path), or a
    tensor of levels whose shape is a leading part of ``shape`` ((N,) or
    (N, L): one level per complex or per residue, the training path).
    ``u``/``frac`` (uniform) and ``gauss`` (standard normal) are the draws,
    each of ``shape``; missing ones come from ``generator``.
    """
    shape = tuple(shape)
    draw = lambda fn: fn(shape, generator=generator, device=device)
    u = draw(torch.rand) if u is None else u
    frac = draw(torch.rand) if frac is None else frac
    gauss = draw(torch.randn) if gauss is None else gauss
    if not torch.is_tensor(t):
        if tables.approx_flag[t]:
            std = float(tables.stddevs[t])
            return torch.fmod((gauss * std + std * 2.0).abs(), math.pi)
        cdf_t = tables.cdf[t].to(u.device)
        # Number of CDF entries below u (the CDF is non-decreasing).
        bin_idx = torch.searchsorted(cdf_t, u.contiguous())
        return (bin_idx.to(torch.float32) + frac) * tables.dx
    # One CDF row per level; each row is searched for the draws it owns.
    t = t.to(u.device).long()
    rows = tables.cdf.to(u.device)[t]                      # t.shape + (B-1,)
    bin_idx = torch.searchsorted(
        rows, u.reshape(t.shape + (-1,)).contiguous()).reshape(shape)
    bin_idx = bin_idx.clamp_(max=rows.shape[-1] - 1)
    hist = (bin_idx.to(torch.float32) + frac) * tables.dx
    per_elem = lambda name: tables.copies(name, u.device)[t].reshape(
        t.shape + (1,) * (len(shape) - t.dim()))
    std = per_elem('stddevs')
    approx = torch.fmod((gauss * std + std * 2.0).abs(), math.pi)
    return torch.where(per_elem('approx_flag'), approx, hist)


def sample_igso3_vector(tables: IGSO3Tables, t, shape, *, axis=None,
                        u=None, frac=None, gauss=None, generator=None,
                        device=None):
    """Random axis, IGSO3-distributed angle -> so3 vectors, shape + (3,).
    ``axis`` (shape + (3,)) standard-normal draws; the rest as
    :func:`sample_igso3_angle`."""
    shape = tuple(shape)
    if axis is None:
        axis = torch.randn(shape + (3,), generator=generator, device=device)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-6)
    theta = sample_igso3_angle(tables, t, shape, u=u, frac=frac, gauss=gauss,
                               generator=generator, device=axis.device)
    return axis * theta[..., None]
