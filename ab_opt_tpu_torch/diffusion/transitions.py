"""R^3 / SO(3) / categorical diffusion transitions (counterpart of
``ab_opt_tpu/diffusion/transitions.py``): the reverse steps the sampler
runs and the forward noising that training runs.

``t`` is either a Python int shared by the whole batch (the sampler's
scalar-t path: every schedule coefficient is a float32 scalar computed on
the host) or a tensor of shape (N,) or (N, L) (training: coefficients are
gathered per complex or residue and broadcast from the left). Every noise
draw is an optional tensor argument (JAX's draws can be fed in); missing
draws come from ``generator``. ``mask_generate`` selects the residues being
generated; context residues pass through.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.so3 import (quaternion_mul, quaternion_to_so3vec,
                            rotation_to_so3vec, so3vec_to_quaternion,
                            so3vec_to_rotation)
from .igso3 import build_igso3_tables, sample_igso3_vector
from .schedule import VarianceSchedule, broadcast_coef


def _mask_mix(mask, new, old):
    """``new`` where mask (broadcast over trailing dims), else ``old``."""
    while mask.dim() < new.dim():
        mask = mask[..., None]
    return torch.where(mask, new, old)


def gumbel_noise(shape, generator=None, device=None):
    """Standard Gumbel draws of ``shape``, from one uniform draw of
    ``generator``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator,
                   device=device) * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


def clamped_one_hot(x, num_classes: int):
    """One-hot that maps out-of-range codes to the zero vector."""
    valid = (x >= 0) & (x < num_classes)
    oh = F.one_hot(torch.clamp(x.long(), 0, num_classes - 1), num_classes)
    return oh.to(torch.float32) * valid[..., None]


class PositionTransition:
    def __init__(self, num_steps: int):
        self.sched = VarianceSchedule.cosine(num_steps)

    def add_noise(self, p_0, mask_generate, t, *, eps=None, generator=None):
        """q(p_t | p_0), closed form, for a tensor ``t``: returns (p_noisy,
        eps); ``eps`` is the standard-normal draw (p_0's shape)."""
        ab = broadcast_coef(self.sched, 'alpha_bars', t, p_0.dim())
        if eps is None:
            eps = torch.randn(p_0.shape, generator=generator,
                              device=p_0.device)
        p_noisy = torch.sqrt(ab) * p_0 + torch.sqrt(1.0 - ab) * eps
        return _mask_mix(mask_generate, p_noisy, p_0), eps

    def denoise(self, p_t, eps_p, mask_generate, t: int, *, z=None,
                generator=None):
        """One ancestral reverse step given predicted noise; ``z`` is the
        standard-normal draw (p_t's shape)."""
        s = self.sched
        alpha = max(s.alphas[t], s.alphas[-2])
        c0 = np.float32(1.0) / np.sqrt(alpha + np.float32(1e-8))
        c1 = (np.float32(1.0) - alpha) / np.sqrt(
            np.float32(1.0) - s.alpha_bars[t] + np.float32(1e-8))
        if t > 1:
            if z is None:
                z = torch.randn(p_t.shape, generator=generator,
                                device=p_t.device)
            noise = float(s.sigmas[t]) * z
        else:
            noise = torch.zeros_like(p_t)
        p_next = float(c0) * (p_t - float(c1) * eps_p) + noise
        return _mask_mix(mask_generate, p_next, p_t)

    def denoise_from_p0(self, p_t, p_0, mask_generate, t: int, *, z=None,
                        generator=None):
        """Posterior-mean reverse step q(p_{t-1} | p_t, p_0) given the
        predicted start ``p_0`` (the graph model's step); ``z`` is the
        standard-normal draw (p_t's shape), zeroed where t <= 1."""
        s = self.sched
        mean = (float(s.posterior_mean_coef1[t]) * p_0
                + float(s.posterior_mean_coef2[t]) * p_t)
        if t > 1:
            if z is None:
                z = torch.randn(p_t.shape, generator=generator,
                                device=p_t.device)
            noise = float(np.sqrt(s.posterior_variance[t])) * z
        else:
            noise = torch.zeros_like(p_t)
        return _mask_mix(mask_generate, mean + noise, p_t)

    def ddim_step(self, p_t, eps_p, mask_generate, t: int, t_next: int):
        """Deterministic DDIM (eta = 0) jump t -> t_next < t, the strided
        sampler's position step: p_0 recovered from the predicted noise,
        re-noised at level t_next with that same noise."""
        s = self.sched
        p_0 = (float(s.sqrt_recip_alpha_bars[t]) * p_t
               - float(s.sqrt_recipm1_alpha_bars[t]) * eps_p)
        ab = s.alpha_bars[t_next]
        p_next = (float(np.sqrt(ab)) * p_0
                  + float(np.sqrt(np.float32(1.0) - ab)) * eps_p)
        return _mask_mix(mask_generate, p_next, p_t)

    def pred_noise_from_start(self, p_t, p_0, mask_generate, t: int):
        """eps = (p_t / sqrt(abar) - p_0) / sqrt(1/abar - 1)."""
        cr = float(self.sched.sqrt_recip_alpha_bars[t])
        crm1 = float(self.sched.sqrt_recipm1_alpha_bars[t])
        return _mask_mix(mask_generate, (cr * p_t - p_0) / crm1, p_t)

    def pred_start_from_noise(self, p_t, eps_p, mask_generate, t):
        """p_0 = p_t / sqrt(abar) - sqrt(1/abar - 1) eps, for a tensor t."""
        n = p_t.dim()
        cr = broadcast_coef(self.sched, 'sqrt_recip_alpha_bars', t, n)
        crm1 = broadcast_coef(self.sched, 'sqrt_recipm1_alpha_bars', t, n)
        return _mask_mix(mask_generate, cr * p_t - crm1 * eps_p, p_t)


class RotationTransition:
    def __init__(self, num_steps: int):
        self.sched = VarianceSchedule.cosine(num_steps)
        # Reverse-step tables (noise levels sigma_t). The forward-noising
        # tables (levels sqrt(1 - alpha_bar)) are built at the first
        # add_noise: sampling never needs them.
        self.igso3_inv = build_igso3_tables(self.sched.sigmas)
        self._igso3_fwd = None

    @property
    def igso3_fwd(self):
        if self._igso3_fwd is None:
            levels = np.sqrt(1.0 - self.sched.alpha_bars)
            self._igso3_fwd = build_igso3_tables(levels).to(
                self.igso3_inv.cdf.device)
        return self._igso3_fwd

    def to(self, device) -> 'RotationTransition':
        self.igso3_inv = self.igso3_inv.to(device)
        if self._igso3_fwd is not None:
            self._igso3_fwd = self._igso3_fwd.to(device)
        return self

    def add_noise(self, v_0, mask_generate, t, *, axis=None, u=None,
                  frac=None, gauss=None, generator=None):
        """Forward noising for a tensor ``t``: an IGSO3(sqrt(1 - alpha_bar))
        rotation composed with the scaled true rotation. Returns (v_noisy,
        e_scaled); draws as :func:`~.igso3.sample_igso3_vector`, each of
        v_0's shape but the last axis."""
        ab = broadcast_coef(self.sched, 'alpha_bars', t, v_0.dim())
        e_scaled = sample_igso3_vector(
            self.igso3_fwd, t, v_0.shape[:-1], axis=axis, u=u, frac=frac,
            gauss=gauss, generator=generator, device=v_0.device)
        R_noisy = (so3vec_to_rotation(e_scaled)
                   @ so3vec_to_rotation(torch.sqrt(ab) * v_0))
        return (_mask_mix(mask_generate, rotation_to_so3vec(R_noisy), v_0),
                e_scaled)

    def denoise(self, v_t, v_next, mask_generate, t: int, *, axis=None,
                u=None, frac=None, gauss=None, generator=None):
        """Reverse step: the network already outputs the updated rotation
        ``v_next``; compose IGSO3(sigma_t) noise except at the last steps
        (t <= 1). A strided step passes its target level t_next as ``t``.
        Draws as :func:`~.igso3.sample_igso3_vector`."""
        shape = v_t.shape[:-1]
        e = sample_igso3_vector(self.igso3_inv, t, shape, axis=axis, u=u,
                                frac=frac, gauss=gauss, generator=generator,
                                device=v_t.device)
        if t <= 1:
            e = torch.zeros_like(e)
        q_out = quaternion_mul(so3vec_to_quaternion(e),
                               so3vec_to_quaternion(v_next))
        return _mask_mix(mask_generate, quaternion_to_so3vec(q_out), v_t)


class SequenceTransition:
    def __init__(self, num_steps: int, num_classes: int = 20):
        self.sched = VarianceSchedule.cosine(num_steps)
        self.num_classes = num_classes

    def _sample(self, c, gumbel=None, generator=None):
        """Categories from (possibly unnormalized) probabilities ``c``;
        ``gumbel`` is the standard Gumbel draw behind the sample (c's
        shape)."""
        if gumbel is None:
            gumbel = gumbel_noise(c.shape, generator, c.device)
        return torch.argmax(torch.log(c + 1e-8) + gumbel, dim=-1)

    def add_noise(self, x_0, mask_generate, t, *, gumbel=None,
                  generator=None):
        """Uniform-noise forward kernel for a tensor ``t``: returns (c_t
        probs, x_t codes)."""
        K = self.num_classes
        c_0 = clamped_one_hot(x_0, K)
        ab = broadcast_coef(self.sched, 'alpha_bars', t, c_0.dim())
        c_t = _mask_mix(mask_generate, ab * c_0 + (1.0 - ab) / K, c_0)
        return c_t, self._sample(c_t, gumbel, generator)

    def posterior(self, x_t, x_0, t):
        """theta(x_{t-1} | x_t, x_0); ``x_t``/``x_0`` are codes (N, L) or
        probabilities (N, L, K); alpha_bar for both factors, as the
        reference does."""
        K = self.num_classes
        c_t, c_0 = (x if x.dim() == 3 else clamped_one_hot(x, K)
                    for x in (x_t, x_0))
        if torch.is_tensor(t):
            a = broadcast_coef(self.sched, 'alpha_bars', t, c_t.dim())
            off = (1.0 - a) / K
        else:
            a = self.sched.alpha_bars[t]
            off = float((np.float32(1.0) - a) / K)
            a = float(a)
        theta = (a * c_t + off) * (a * c_0 + off)
        return theta / (theta.sum(-1, keepdim=True) + 1e-8)

    def denoise(self, x_t, c_0_pred, mask_generate, t: int, *, gumbel=None,
                generator=None):
        """Reverse step: (posterior probs, sampled codes). ``gumbel`` is the
        standard Gumbel draw behind the categorical sample, (..., K)."""
        c_t = clamped_one_hot(x_t, self.num_classes)
        post = _mask_mix(mask_generate, self.posterior(c_t, c_0_pred, t), c_t)
        return post, self._sample(post, gumbel, generator)
