"""Seeded weights, made on the device in one draw.

Every parameter of a model, in the order of ``named_parameters``, is a
slice of one standard-normal vector drawn from a generator on the device,
scaled by a rule of its shape: a matrix (or any tensor of two or more
axes) by ``1 / sqrt(3 fan_in)`` (the spread of PyTorch's default Linear
initialisation), a LayerNorm gain ``gamma`` by 0.1 about 1, every other
vector (biases, ``beta``) by 0.05. A configuration's ``weight_scales``
overrides the scale of the parameters whose name ends with a key (the
graph model's coordinate heads start near zero, as its own initialiser
starts them). The model and the reference load the same values."""
from __future__ import annotations

import math

import torch


def _scale(name: str, p: torch.Tensor, overrides: dict) -> float:
    for suffix, s in overrides.items():
        if name.endswith(suffix):
            return float(s)
    if p.dim() >= 2:
        return 1.0 / math.sqrt(3.0 * p.shape[-1])
    return 0.1 if name.endswith('gamma') else 0.05


@torch.no_grad()
def seeded_state(model: torch.nn.Module, seed: int, device,
                 overrides=None) -> dict:
    """A state dict of ``model``'s parameters drawn from ``seed`` on
    ``device`` (float32)."""
    named = list(model.named_parameters())
    total = sum(p.numel() for _, p in named)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    state, o = {}, 0
    for name, p in named:
        v = flat[o:o + p.numel()].view(p.shape) * _scale(name, p,
                                                          overrides or {})
        if name.endswith('gamma'):
            v = v + 1.0
        state[name] = v
        o += p.numel()
    return state


@torch.no_grad()
def load_state(model: torch.nn.Module, state: dict):
    """Copy ``state`` into ``model``'s parameters (same names)."""
    params = dict(model.named_parameters())
    missing = set(params) - set(state)
    if missing:
        raise KeyError(f'no seeded value for {sorted(missing)[:5]}')
    for name, p in params.items():
        p.copy_(state[name])
