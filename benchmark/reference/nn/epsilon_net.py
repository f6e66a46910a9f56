"""The denoiser of the port's ``nn/epsilon_net.py``, eager: sequence
mix-in -> GAEncoder -> per-modality heads. Outputs per call:
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
from .ipa import GAEncoder
from .layers import Embedding, PerResiduePredictor, mlp


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
                mask_res, reps: int = 1):
        """v_t (N, L, 3) so3 vectors, p_t (N, L, 3) normalized positions, s_t
        (N, L) codes, res_feat (N, L, F), pair_feat (N // reps, L, L, C),
        beta (N,)."""
        N, L = mask_res.shape
        R9 = so3vec_to_rotation_planar(v_t)                   # (N, L, 9)

        seq_embed = self.current_sequence_embedding(s_t)
        res_feat = self.res_feat_mixer(
            torch.cat([res_feat.float(), seq_embed.float()], dim=-1))
        res_feat = self.encoder(R9, p_t, res_feat, pair_feat, mask_res,
                                reps=reps)

        t_embed = torch.stack([beta, torch.sin(beta), torch.cos(beta)], -1)
        in_feat = torch.cat([res_feat.float(),
                             t_embed[:, None, :].expand(N, L, 3)], dim=-1)
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
