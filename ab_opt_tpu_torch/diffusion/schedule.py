"""Improved-DDPM cosine variance schedule (counterpart of
``ab_opt_tpu/diffusion/schedule.py``).

Tables are built host-side in numpy float32, exactly as the JAX package
builds them, and stay numpy: the sampler indexes them with a Python int t,
so every coefficient is a float32 scalar computed on the host; training
indexes them with a tensor t through :func:`broadcast_coef`, in the
schedule's copies of them on t's device (``copies``, made once a device).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import DeviceCopies


class VarianceSchedule(NamedTuple):
    betas: np.ndarray
    alphas: np.ndarray
    alpha_bars: np.ndarray
    sigmas: np.ndarray
    sqrt_recip_alpha_bars: np.ndarray
    sqrt_recipm1_alpha_bars: np.ndarray
    posterior_variance: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    copies: DeviceCopies        # the tables above on the devices t lies on

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0] - 1

    @classmethod
    def cosine(cls, num_steps: int = 100, s: float = 0.01) -> 'VarianceSchedule':
        T = num_steps
        t = np.arange(0, T + 1, dtype=np.float32)
        f_t = np.cos((np.pi / 2.0) * ((t / T) + s) / (1.0 + s)) ** 2
        alpha_bars = f_t / f_t[0]

        betas = 1.0 - alpha_bars[1:] / alpha_bars[:-1]
        betas = np.concatenate([[0.0], betas]).astype(np.float32)
        betas = np.minimum(betas, 0.999)
        alphas = 1.0 - betas

        sigmas_sq = np.zeros_like(betas)
        sigmas_sq[1:] = (1.0 - alpha_bars[:-1]) / (1.0 - alpha_bars[1:]) * betas[1:]
        sigmas = np.sqrt(sigmas_sq)

        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        with np.errstate(divide='ignore', invalid='ignore'):
            denom = 1.0 - alphas_cumprod
            denom[denom == 0] = np.inf
            posterior_variance = betas * (1.0 - alphas_cumprod_prev) / denom
            posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / denom
            posterior_mean_coef2 = ((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                    / denom)

        f32 = lambda x: np.asarray(x, np.float32)
        tables = dict(
            betas=f32(betas), alphas=f32(alphas), alpha_bars=f32(alpha_bars),
            sigmas=f32(sigmas),
            sqrt_recip_alpha_bars=f32(np.sqrt(1.0 / alpha_bars)),
            sqrt_recipm1_alpha_bars=f32(np.sqrt(1.0 / alpha_bars - 1.0)),
            posterior_variance=f32(posterior_variance),
            posterior_mean_coef1=f32(posterior_mean_coef1),
            posterior_mean_coef2=f32(posterior_mean_coef2),
        )
        return cls(**tables, copies=DeviceCopies(tables))


def broadcast_coef(sched: VarianceSchedule, name: str, t: torch.Tensor,
                   ref_ndim: int) -> torch.Tensor:
    """``sched``'s table ``name`` at ``t``, a tensor of shape (N,) or (N,
    L): a float32 tensor on ``t``'s device with axes padded on the right to
    broadcast against a tensor of ``ref_ndim`` dims."""
    c = sched.copies(name, t.device)[t.long()]
    while c.dim() < ref_ndim:
        c = c[..., None]
    return c
