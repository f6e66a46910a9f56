"""Residue and pair feature embeddings (counterpart of
``ab_opt_tpu/nn/embeddings.py``, with the reference's module names)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..constants import AA_UNK, MAX_AA_TYPES, BBHeavyAtom
from ..geometry import (angstrom_to_nm, construct_3d_basis,
                        get_backbone_dihedral_angles, global_to_local,
                        pairwise_dihedrals)
from .layers import AngularEncoding, Embedding, mlp


class ResidueEmbedding(nn.Module):
    """Per-residue features (N, L, feat_dim).

    With ``hotspot`` the module also embeds the AbDesign hotspot codes (1
    non-hotspot, 2 hotspot, 0 padding: ``hotspot_embed``), concatenated
    last before the MLP, whose input is that much wider. The width is fixed
    here, so such a module needs the codes at every call (JAX's flax module
    takes its width from the batch it was initialised on)."""

    def __init__(self, feat_dim: int, max_num_atoms: int,
                 max_aa_types: int = MAX_AA_TYPES, dtype=torch.float32,
                 hotspot: bool = False):
        super().__init__()
        self.max_num_atoms = max_num_atoms
        self.max_aa_types = max_aa_types
        self.aatype_embed = Embedding(max_aa_types, feat_dim, dtype=dtype)
        self.type_embed = Embedding(10, feat_dim, dtype=dtype)
        self.dihed_embed = AngularEncoding()
        in_dim = (2 * feat_dim + max_aa_types * max_num_atoms * 3
                  + self.dihed_embed.get_out_dim(3))
        if hotspot:
            self.hotspot_embed = Embedding(10, feat_dim, dtype=dtype)
            in_dim += feat_dim
        self.hotspot = hotspot
        self.mlp = mlp(in_dim, (feat_dim * 2, feat_dim, feat_dim, feat_dim),
                       dtype)

    def forward(self, aa, res_nb, chain_nb, pos_atoms, mask_atoms,
                fragment_type, structure_mask=None, sequence_mask=None,
                hotspot=None):
        if (hotspot is not None) != self.hotspot:
            raise ValueError(
                'this ResidueEmbedding was built with hotspot conditioning, '
                'and the batch has no hotspot_label (the '
                'patch_around_anchor_hotspot transform writes it)'
                if self.hotspot else
                'hotspot codes given to a ResidueEmbedding built without '
                'hotspot conditioning')
        N, L = aa.shape
        A = self.max_num_atoms
        pos_atoms = pos_atoms[:, :, :A].float()
        mask_atoms = mask_atoms[:, :, :A]
        mask_residue = mask_atoms[:, :, BBHeavyAtom.CA]

        if sequence_mask is not None:
            aa = torch.where(sequence_mask, aa, torch.full_like(aa, AA_UNK))
        aa_feat = self.aatype_embed(aa)

        R = construct_3d_basis(pos_atoms[:, :, BBHeavyAtom.CA],
                               pos_atoms[:, :, BBHeavyAtom.C],
                               pos_atoms[:, :, BBHeavyAtom.N])
        t = pos_atoms[:, :, BBHeavyAtom.CA]
        crd = global_to_local(R, t, pos_atoms) * mask_atoms[..., None]
        aa_onehot = F.one_hot(torch.clamp(aa.long(), 0, self.max_aa_types - 1),
                              self.max_aa_types).to(crd.dtype)
        crd_feat = (aa_onehot[:, :, :, None, None] * crd[:, :, None]
                    ).reshape(N, L, self.max_aa_types * A * 3)
        if structure_mask is not None:
            crd_feat = crd_feat * structure_mask[:, :, None]

        bb_dihedral, mask_bb_dihed = get_backbone_dihedral_angles(
            pos_atoms, chain_nb=chain_nb, res_nb=res_nb, mask=mask_residue)
        dihed_feat = (self.dihed_embed(bb_dihedral[..., None])
                      * mask_bb_dihed[..., None]).reshape(N, L, -1)
        if structure_mask is not None:
            # Neighbours' atoms enter this residue's dihedrals.
            dihed_mask = (structure_mask & torch.roll(structure_mask, 1, 1)
                          & torch.roll(structure_mask, -1, 1))
            dihed_feat = dihed_feat * dihed_mask[:, :, None]

        type_feat = self.type_embed(fragment_type) * (fragment_type > 0)[..., None]
        feats = [aa_feat.float(), crd_feat, dihed_feat, type_feat.float()]
        if hotspot is not None:
            feats.append((self.hotspot_embed(hotspot)
                          * (hotspot > 0)[..., None]).float())
        return self.mlp(torch.cat(feats, dim=-1)) * mask_residue[:, :, None]


class PairEmbedding(nn.Module):
    """Pairwise features (N, L, L, feat_dim)."""

    def __init__(self, feat_dim: int, max_num_atoms: int,
                 max_aa_types: int = MAX_AA_TYPES, max_relpos: int = 32,
                 dtype=torch.float32):
        super().__init__()
        A = max_num_atoms
        self.max_num_atoms = A
        self.max_aa_types = max_aa_types
        self.max_relpos = max_relpos
        self.aa_pair_embed = Embedding(max_aa_types ** 2, feat_dim, dtype=dtype)
        self.relpos_embed = Embedding(2 * max_relpos + 1, feat_dim, dtype=dtype)
        self.aapair_to_distcoef = Embedding(max_aa_types ** 2, A * A,
                                            dtype=dtype)
        nn.init.zeros_(self.aapair_to_distcoef.weight)
        self.distance_embed = nn.Sequential(*mlp(A * A, (feat_dim, feat_dim),
                                                 dtype), nn.ReLU())
        self.dihed_embed = AngularEncoding()
        in_dim = 3 * feat_dim + self.dihed_embed.get_out_dim(2)
        self.out_mlp = mlp(in_dim, (feat_dim, feat_dim, feat_dim), dtype)

    def forward(self, aa, res_nb, chain_nb, pos_atoms, mask_atoms,
                structure_mask=None, sequence_mask=None):
        N, L = aa.shape
        A = self.max_num_atoms
        pos_atoms = pos_atoms[:, :, :A].float()
        mask_atoms = mask_atoms[:, :, :A]
        mask_residue = mask_atoms[:, :, BBHeavyAtom.CA]
        mask_pair = mask_residue[:, :, None] & mask_residue[:, None, :]
        pair_structure_mask = (
            structure_mask[:, :, None] & structure_mask[:, None, :]
            if structure_mask is not None else None)

        if sequence_mask is not None:
            aa = torch.where(sequence_mask, aa, torch.full_like(aa, AA_UNK))
        aa = torch.clamp(aa.long(), 0, self.max_aa_types - 1)
        aa_pair = aa[:, :, None] * self.max_aa_types + aa[:, None, :]
        feat_aapair = self.aa_pair_embed(aa_pair)

        same_chain = chain_nb[:, :, None] == chain_nb[:, None, :]
        relpos = torch.clamp(res_nb[:, :, None] - res_nb[:, None, :],
                             -self.max_relpos, self.max_relpos)
        feat_relpos = (self.relpos_embed(relpos.long() + self.max_relpos)
                       * same_chain[..., None])

        # d2 = |p_ia|^2 + |p_jb|^2 - 2 <p_ia, p_jb>, float32.
        p = angstrom_to_nm(pos_atoms)
        sq = p.square().sum(-1)
        cross = torch.einsum('niax,njbx->nijab', p, p)
        d2 = torch.clamp(sq[:, :, None, :, None] + sq[:, None, :, None, :]
                         - 2.0 * cross, min=0.0).reshape(N, L, L, A * A)
        c = F.softplus(self.aapair_to_distcoef(aa_pair)).float()
        mask_atom_pair = (mask_atoms[:, :, None, :, None]
                          & mask_atoms[:, None, :, None, :]).reshape(N, L, L, A * A)
        feat_dist = self.distance_embed(torch.exp(-c * d2) * mask_atom_pair)
        if pair_structure_mask is not None:
            feat_dist = feat_dist * pair_structure_mask[..., None]

        feat_dihed = self.dihed_embed(pairwise_dihedrals(pos_atoms))
        if pair_structure_mask is not None:
            feat_dihed = feat_dihed * pair_structure_mask[..., None]

        feat_all = torch.cat([feat_aapair.float(), feat_relpos.float(),
                              feat_dist.float(), feat_dihed], dim=-1)
        return self.out_mlp(feat_all) * mask_pair[..., None]
