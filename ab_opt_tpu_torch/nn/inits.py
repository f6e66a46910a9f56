"""AlphaFold-style parameter initialisers (the port's copy of
``ab_opt_tpu/nn/inits.py``, the reference's Linear init vocabulary).

Each fills a weight in place from an explicit ``torch.Generator`` and
returns it; fans are read in torch's (out, in) layout (fan_in the last
axis). The truncated normals are flax's ``variance_scaling(...,
'truncated_normal')``: a normal cut at two standard deviations, its std
divided by the cut normal's own std (0.87962566) so that the samples keep
the asked variance.

  default  lecun normal (truncated)
  relu     he normal (truncated)
  glorot   xavier uniform
  gating   zeros (bias ones handled by the caller)
  final    zeros
  normal   kaiming normal (fan_in)
"""
from __future__ import annotations

import math

import torch

TRUNCATED_STD = 0.87962566103423978   # std of a unit normal cut at +-2


def _fans(t: torch.Tensor):
    receptive = math.prod(t.shape[2:]) if t.dim() > 2 else 1
    return t.shape[-1] * receptive, t.shape[0] * receptive


def _variance_scaling(scale: float, distribution: str):
    def init(t: torch.Tensor, generator=None) -> torch.Tensor:
        fan_in, _ = _fans(t)
        std = math.sqrt(scale / fan_in)
        with torch.no_grad():
            if distribution == 'truncated_normal':
                std /= TRUNCATED_STD
                return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std,
                                                   2 * std,
                                                   generator=generator)
            return t.normal_(0.0, std, generator=generator)
    return init


def glorot_init(t: torch.Tensor, generator=None) -> torch.Tensor:
    fan_in, fan_out = _fans(t)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def zeros_init(t: torch.Tensor, generator=None) -> torch.Tensor:
    with torch.no_grad():
        return t.zero_()


lecun_init = _variance_scaling(1.0, 'truncated_normal')
relu_init = _variance_scaling(2.0, 'truncated_normal')
gating_init = zeros_init
final_init = zeros_init
normal_init = _variance_scaling(2.0, 'normal')

INIT_BY_NAME = {
    'default': lecun_init,
    'relu': relu_init,
    'glorot': glorot_init,
    'gating': gating_init,
    'final': final_init,
    'normal': normal_init,
}
