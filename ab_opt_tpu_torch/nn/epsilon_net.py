"""The denoiser: sequence mix-in -> GAEncoder -> per-modality heads.

Counterpart of ``ab_opt_tpu/nn/epsilon_net.py``. Outputs per call:
v_next (N, L, 3) updated orientations, R_next (N, L, 3, 3), eps_pos
(N, L, 3), c_denoised (N, L, 20) and per-complex prmsd_logits (N, bins).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..geometry import (planar_apply_to_vector, planar_compose,
                        planar_rotation_to_so3vec, planar_to_matrix,
                        quaternion_1ijk_to_rotation_planar,
                        so3vec_to_rotation_planar)
from ..utils.profiling import span
from .ipa import GAEncoder
from .layers import Embedding, PerResiduePredictor, mlp


def precompute_head_weights(eps_net, dtype=torch.bfloat16) -> dict:
    """Stack the four per-step output heads into batched-GEMM operands:
    layer 1 of the three MLP heads as one (F+3, 3F) matrix, layers 2 and 3
    of all four heads (with the pRMSD predictor) as (4, ., .) stacks, the
    last layers zero-padded to one width. Built once per sampling call."""
    heads = [eps_net.eps_crd_net, eps_net.eps_rot_net, eps_net.eps_seq_net]
    pr = eps_net.prmsd_predictor
    l1 = [h[0] for h in heads]
    l2 = [h[2] for h in heads] + [pr.linear_2]
    l3 = [h[4] for h in heads] + [pr.linear_3]
    omax = max(m.out_features for m in l3)
    kern = lambda m: m.weight.detach().t().float()
    pad_k = lambda m: nn.functional.pad(kern(m), (0, omax - m.out_features))
    pad_b = lambda m: nn.functional.pad(m.bias.detach().float(),
                                        (0, omax - m.out_features))
    cast = lambda a: a.to(dtype).contiguous()
    return {
        'w1': cast(torch.cat([kern(m) for m in l1], 1)),
        'b1': cast(torch.cat([m.bias.detach() for m in l1])),
        'w1p': cast(kern(pr.linear_1)), 'b1p': cast(pr.linear_1.bias.detach()),
        'w2': cast(torch.stack([kern(m) for m in l2])),
        'b2': cast(torch.stack([m.bias.detach() for m in l2])[:, None]),
        'w3': cast(torch.stack([pad_k(m) for m in l3])),
        'b3': cast(torch.stack([pad_b(m) for m in l3])[:, None]),
        'ln': pr.layer_norm,
    }


def apply_fused_heads(in_feat, hw, F: int, num_bins: int, dtype):
    """Batched evaluation of the four heads (see precompute_head_weights)."""
    N, L = in_feat.shape[:2]
    x = in_feat.reshape(N * L, -1).float()
    h1 = torch.relu(x.to(dtype) @ hw['w1'] + hw['b1'])
    h1p = torch.relu(hw['ln'](x).to(dtype) @ hw['w1p'] + hw['b1p'])
    h = torch.stack([h1[:, :F], h1[:, F:2 * F], h1[:, 2 * F:], h1p])
    h = torch.relu(torch.bmm(h, hw['w2']) + hw['b2'])
    out = torch.bmm(h, hw['w3']) + hw['b3']
    shp = lambda i, w: out[i, :, :w].reshape(N, L, w)
    return shp(0, 3), shp(1, 3), shp(2, 20), shp(3, num_bins)


class EpsilonNet(nn.Module):
    def __init__(self, res_feat_dim: int, pair_feat_dim: int, num_layers: int,
                 num_bins: int = 20, dtype=torch.float32):
        super().__init__()
        F = res_feat_dim
        self.res_feat_dim, self.num_bins, self.dtype = F, num_bins, dtype
        self.current_sequence_embedding = Embedding(25, F, dtype=dtype)
        self.res_feat_mixer = mlp(2 * F, (F, F), dtype)
        self.encoder = GAEncoder(F, pair_feat_dim, num_layers, dtype=dtype)
        self.eps_crd_net = mlp(F + 3, (F, F, 3), dtype)
        self.eps_rot_net = mlp(F + 3, (F, F, 3), dtype)
        self.eps_seq_net = mlp(F + 3, (F, F, 20), dtype)
        self.prmsd_predictor = PerResiduePredictor(F + 3, num_bins, F, dtype)

    def forward(self, v_t, p_t, s_t, res_feat, pair_feat, beta, mask_generate,
                mask_res, reps: int = 1, encoder_fn=None, head_weights=None,
                attention=None):
        """v_t (N, L, 3) so3 vectors, p_t (N, L, 3) normalized positions, s_t
        (N, L) codes, res_feat (N, L, F), pair_feat (N // reps, L, L, C),
        beta (N,). ``encoder_fn(R9, t, x, mask) -> x`` replaces the eager
        GAEncoder (the sampler passes the GABlock kernel path);
        ``head_weights`` selects the batched heads (built detached: sampling
        only; training uses the per-head modules); ``attention`` is passed
        to the eager GAEncoder's blocks."""
        N, L = mask_res.shape
        F = self.res_feat_dim
        R9 = so3vec_to_rotation_planar(v_t)                   # (N, L, 9)

        seq_embed = self.current_sequence_embedding(s_t)
        res_feat = self.res_feat_mixer(
            torch.cat([res_feat.float(), seq_embed.float()], dim=-1))
        with span('denoiser.encoder'):
            if encoder_fn is not None:
                res_feat = encoder_fn(R9, p_t, res_feat, mask_res)
            else:
                res_feat = self.encoder(R9, p_t, res_feat, pair_feat,
                                        mask_res, reps=reps,
                                        attention=attention)

        t_embed = torch.stack([beta, torch.sin(beta), torch.cos(beta)], -1)
        in_feat = torch.cat([res_feat.float(),
                             t_embed[:, None, :].expand(N, L, 3)], dim=-1)
        if head_weights is not None:
            eps_crd, eps_rot, seq_logits, prmsd_logits = apply_fused_heads(
                in_feat, head_weights, F, self.num_bins, self.dtype)
        else:
            eps_crd = self.eps_crd_net(in_feat)
            eps_rot = self.eps_rot_net(in_feat)
            seq_logits = self.eps_seq_net(in_feat)
            prmsd_logits = self.prmsd_predictor(in_feat)

        gen = mask_generate[..., None]
        eps_pos = planar_apply_to_vector(R9, eps_crd.float())
        eps_pos = torch.where(gen, eps_pos, torch.zeros_like(eps_pos))
        # Rotation update composed in float32 (orthogonality breaks in bf16).
        Rn9 = planar_compose(R9, quaternion_1ijk_to_rotation_planar(
            eps_rot.float()))
        v_next = torch.where(gen, planar_rotation_to_so3vec(Rn9), v_t)
        c_denoised = torch.softmax(seq_logits, dim=-1)
        # Per-complex score: mean over all L, padding included (reference).
        return (v_next, planar_to_matrix(Rn9), eps_pos, c_denoised,
                prmsd_logits.mean(dim=1))
