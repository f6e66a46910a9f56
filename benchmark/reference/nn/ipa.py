"""The GABlock / GAEncoder of the port's ``nn/ipa.py`` (the reference's
module names, the interleaved (head, point, xyz) point layout and the
augmented 64-wide per-head operands qa / ka / vvp), with its attention in
plain float32 PyTorch in place of the kernels."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry import normalize_vector

SLOT = 64       # per-head width of qa / ka / vvp
from .layers import LayerNorm, Linear, mlp

_INV_SQRT3 = math.sqrt(1.0 / 3.0)
_NEG_BIG = 1e5


def _heads(a):
    N, L, HD = a.shape
    return a.reshape(N, L, HD // SLOT, SLOT).float()


def ipa_attention(qa, ka, vvp, bias, reps: int = 1, rounding=None):
    """softmax(qa . ka + bias[n // reps]) and alpha . vvp in float32
    (alpha rounded by ``rounding`` before the value product, if given):
    returns (out (N, L, H*64), alphas (N, H, L, L))."""
    N, L, HD = qa.shape
    H = HD // SLOT
    logits = torch.einsum('nihd,njhd->nhij', _heads(qa), _heads(ka))
    logits = (logits.reshape(N // reps, reps, H, L, L)
              + bias.float()[:, None]).reshape(N, H, L, L)
    alphas = torch.softmax(logits, dim=-1)
    if rounding is not None:
        alphas = rounding(alphas)
    out = torch.einsum('nhij,njhd->nihd', alphas, _heads(vvp))
    return out.reshape(N, L, HD), alphas


def p2n_aggregate(alphas, z, reps: int = 1):
    """sum_j alpha[n, h, i, j] z[n // reps, i, j, c] -> (N, L, H, Cz)."""
    N, H, L, _ = alphas.shape
    Cz = z.shape[-1]
    a = alphas.reshape(N // reps, reps, H, L, L)
    p2n = torch.einsum('crhij,cijd->crihd', a, z.float())
    return p2n.reshape(N, L, H, Cz)


class GABlock(nn.Module):
    def __init__(self, node_feat_dim: int, pair_feat_dim: int,
                 value_dim: int = 32, query_key_dim: int = 32,
                 num_query_points: int = 8, num_value_points: int = 8,
                 num_heads: int = 12, bias: bool = False, dtype=torch.float32):
        super().__init__()
        F_, H = node_feat_dim, num_heads
        self.node_feat_dim, self.pair_feat_dim = node_feat_dim, pair_feat_dim
        self.dims = (H, query_key_dim, value_dim, num_query_points,
                     num_value_points)
        self.dtype = dtype
        lin = lambda i, o, b=bias: Linear(i, o, bias=b, dtype=dtype)
        self.proj_query = lin(F_, H * query_key_dim)
        self.proj_key = lin(F_, H * query_key_dim)
        self.proj_value = lin(F_, H * value_dim)
        self.proj_pair_bias = lin(pair_feat_dim, H)
        self.proj_query_point = lin(F_, H * num_query_points * 3)
        self.proj_key_point = lin(F_, H * num_query_points * 3)
        self.proj_value_point = lin(F_, H * num_value_points * 3)
        self.spatial_coef = nn.Parameter(
            torch.full((1, 1, 1, H), math.log(math.exp(1.0) - 1.0)))
        in_feat = H * (pair_feat_dim + value_dim + num_value_points * 7)
        self.out_transform = lin(in_feat, F_, True)
        self.layer_norm_1 = LayerNorm(F_)
        self.mlp_transition = mlp(F_, (F_, F_, F_), dtype)
        self.layer_norm_2 = LayerNorm(F_)
        # A lower compute dtype of the attention's operands, alphas and
        # outputs (None: the compute dtype's own).
        self.operand_rounding = None

    def spatial_coefficient(self):
        """-softplus(gamma) * sqrt(2 / (9 P)) / 2, per head, float32."""
        P = self.dims[3]
        gamma = F.softplus(self.spatial_coef.float()).reshape(-1)
        return -gamma * math.sqrt(2.0 / (9.0 * P)) / 2.0

    def attention_operands(self, R, t, x):
        """qa, ka, vvp (N, L, H*64) in the compute dtype, the per-head slot
        layout of the JAX fused path:
        qa = [q/sqrt(3 QK) | -2c qp | c |qp|^2 | c | 0],
        ka = [k | kp | 1 | |kp|^2 | 0], vvp = [v | vp | 0], with the points
        in the global frame, planar per head ([x (P) | y (P) | z (P)]) and
        c the spatial coefficient over sqrt(3), so qa . ka is the node plus
        spatial logit, pre-scaled by 1/sqrt(3). Rotations in float32."""
        N, L = x.shape[:2]
        H, QK, V, P, PV = self.dims
        f32 = torch.float32
        R, t = R.reshape(N, L, 3, 3).to(f32), t.to(f32)

        def points(lin, n):       # (N, L, H, 3, n) global, planar per head
            p = lin(x).to(f32).reshape(N, L, H * n, 3)
            g = torch.einsum('nlcd,nlkd->nlkc', R, p) + t[:, :, None, :]
            return g.reshape(N, L, H, n, 3).transpose(-1, -2)

        qg, kg = points(self.proj_query_point, P), points(self.proj_key_point, P)
        vg = points(self.proj_value_point, PV)
        coef = self.spatial_coefficient() * _INV_SQRT3        # (H,) f32
        sq_q, sq_k = qg.square().sum((-1, -2)), kg.square().sum((-1, -2))
        one = torch.ones_like(sq_q)
        heads = lambda lin, n: lin(x).to(f32).reshape(N, L, H, n)
        flat = lambda g: g.reshape(N, L, H, -1)

        def slots(parts):
            a = torch.cat(parts, -1)
            a = F.pad(a, (0, SLOT - a.shape[-1]))
            return a.to(self.dtype).reshape(N, L, H * SLOT).contiguous()

        qa = slots([heads(self.proj_query, QK) / math.sqrt(3.0 * QK),
                    (-2.0 * coef)[:, None] * flat(qg),
                    (coef * sq_q)[..., None], (coef * one)[..., None]])
        ka = slots([heads(self.proj_key, QK), flat(kg), one[..., None],
                    sq_k[..., None]])
        vvp = slots([heads(self.proj_value, V), flat(vg)])
        return qa, ka, vvp

    def forward(self, R, t, x, z, mask, reps: int = 1, pair_bias=None):
        """R (N, L, 3, 3) or planar (N, L, 9); t (N, L, 3); x (N, L, F);
        z (N // reps, L, L, Cz) per complex; mask (N, L) bool.
        ``pair_bias``: this block's (N // reps, H, L, L) bias from
        :func:`precompute_pair_bias` (else built here)."""
        N, L = x.shape[:2]
        H, QK, V, P, PV = self.dims
        dt = self.dtype
        mask = mask.bool()
        qa, ka, vvp = self.attention_operands(R, t, x)
        if pair_bias is None:
            pair_bias = precompute_pair_bias(
                z, self.proj_pair_bias.weight.t(), mask[::reps], dt)
        r = self.operand_rounding or (lambda a: a)
        out, alphas = ipa_attention(r(qa), r(ka), r(vvp), r(pair_bias), reps,
                                    r)
        p2n = r(p2n_aggregate(alphas, r(z), reps).to(dt))
        out = r(out.to(dt))

        # Zero the attention outputs of masked query rows (the reference
        # zeroes their alpha rows).
        rowm = mask.to(dt)[:, :, None, None]
        feat_p2n = (p2n * rowm).reshape(N, L, -1)
        out = out.reshape(N, L, H, SLOT) * rowm
        feat_node = out[..., :V].reshape(N, L, H * V)
        aggr = (out[..., V:V + 3 * PV].reshape(N, L, H, 3, PV)
                .transpose(-1, -2).reshape(N, L, H * PV, 3).float())
        R, t = R.reshape(N, L, 3, 3).float(), t.float()
        feat_points = torch.einsum('nldc,nlkd->nlkc', R,
                                   aggr - t[:, :, None, :])   # R^T (g - t)
        feat_distance = torch.sqrt(feat_points.square().sum(-1) + 1e-12)
        feat_direction = normalize_vector(feat_points, dim=-1, eps=1e-4)
        feat_spatial = torch.cat([feat_points.reshape(N, L, -1), feat_distance,
                                  feat_direction.reshape(N, L, -1)], dim=-1)

        feat_all = self.out_transform(
            torch.cat([feat_p2n, feat_node, feat_spatial], dim=-1))
        feat_all = torch.where(mask[..., None], feat_all,
                               torch.zeros_like(feat_all))
        x = self.layer_norm_1(x.float() + feat_all.float())
        return self.layer_norm_2(x + self.mlp_transition(x).float())


class GAEncoder(nn.Module):
    """Stack of GABlocks (``blocks.{i}``). ``pair_biases``: the blocks'
    hoisted biases (:func:`precompute_encoder_pair_biases`); ``fuse_p2n``
    selects the blocks' sampling form."""

    def __init__(self, node_feat_dim: int, pair_feat_dim: int,
                 num_layers: int, dtype=torch.float32, **block_opt):
        super().__init__()
        self.blocks = nn.ModuleList([
            GABlock(node_feat_dim, pair_feat_dim, dtype=dtype, **block_opt)
            for _ in range(num_layers)])

    def forward(self, R, t, res_feat, pair_feat, mask, reps: int = 1,
                pair_biases=None):
        for i, block in enumerate(self.blocks):
            res_feat = block(
                R, t, res_feat, pair_feat, mask, reps=reps,
                pair_bias=None if pair_biases is None else pair_biases[i])
        return res_feat


def precompute_pair_bias(z, pair_w, mask, out_dtype=None):
    """Head-major pair-attention bias per complex, constant across steps:
    bias[n, h, i, j] = (sum_c z[n,i,j,c] W[c,h]) / sqrt(3) - 1e5 (1 - mask[n,j]).
    z (Nc, L, L, Cz), pair_w (Cz, H), mask (Nc, L)."""
    bias = torch.einsum('nijc,ch->nhij', z.float(), pair_w.float()) * _INV_SQRT3
    col = (mask.float() - 1.0) * _NEG_BIG
    return (bias + col[:, None, None, :]).to(out_dtype or z.dtype).contiguous()


def precompute_encoder_pair_biases(encoder: GAEncoder, z, mask, dtype=None):
    """Every block's pair bias, hoisted out of the sampling loop: a list of
    (Nc, H, L, L) tensors."""
    return [precompute_pair_bias(z, b.proj_pair_bias.weight.t(), mask, dtype)
            for b in encoder.blocks]
