"""Backbone dihedral angles and chain-topology flags (counterpart of
``ab_opt_tpu/geometry/dihedrals.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import BBHeavyAtom


def dihedral_from_four_points(p0, p1, p2, p3):
    """Signed dihedral angle of four points (..., 3) -> (...,) radians."""
    v0 = p2 - p1
    v1 = p0 - p1
    v2 = p3 - p2
    u1 = torch.linalg.cross(v0, v1, dim=-1)
    u2 = torch.linalg.cross(v0, v2, dim=-1)
    n1 = u1 / torch.sqrt(torch.clamp(u1.square().sum(-1, keepdim=True),
                                     min=1e-12))
    n2 = u2 / torch.sqrt(torch.clamp(u2.square().sum(-1, keepdim=True),
                                     min=1e-12))
    sgn = torch.sign((torch.linalg.cross(v1, v2, dim=-1) * v0).sum(-1))
    cosang = torch.clamp((n1 * n2).sum(-1), -0.999999, 0.999999)
    return sgn * torch.arccos(cosang)


def get_consecutive_flag(chain_nb, res_nb, mask):
    """Whether residue i is peptide-bonded to residue i+1. -> (..., L-1)."""
    d = (res_nb[..., 1:] - res_nb[..., :-1]).abs()
    same_chain = chain_nb[..., 1:] == chain_nb[..., :-1]
    return (d == 1) & same_chain & mask[..., :-1].bool()


def get_terminus_flag(chain_nb, res_nb, mask):
    """N-/C-terminus flags, each (..., L) bool."""
    consec = get_consecutive_flag(chain_nb, res_nb, mask)
    pad = torch.ones(consec.shape[:-1] + (1,), dtype=torch.bool,
                     device=consec.device)
    return torch.cat([pad, ~consec], -1), torch.cat([~consec, pad], -1)


def get_backbone_dihedral_angles(pos_atoms, chain_nb, res_nb, mask):
    """Omega/phi/psi per residue: (bb_dihedral, mask_bb_dihed), (..., L, 3)."""
    pos_n = pos_atoms[..., BBHeavyAtom.N, :]
    pos_ca = pos_atoms[..., BBHeavyAtom.CA, :]
    pos_c = pos_atoms[..., BBHeavyAtom.C, :]
    n_term, c_term = get_terminus_flag(chain_nb, res_nb, mask)

    omega = F.pad(dihedral_from_four_points(
        pos_ca[..., :-1, :], pos_c[..., :-1, :], pos_n[..., 1:, :],
        pos_ca[..., 1:, :]), (1, 0))
    phi = F.pad(dihedral_from_four_points(
        pos_c[..., :-1, :], pos_n[..., 1:, :], pos_ca[..., 1:, :],
        pos_c[..., 1:, :]), (1, 0))
    psi = F.pad(dihedral_from_four_points(
        pos_n[..., :-1, :], pos_ca[..., :-1, :], pos_c[..., :-1, :],
        pos_n[..., 1:, :]), (0, 1))

    mask_bb_dihed = torch.stack([~n_term, ~n_term, ~c_term], dim=-1)
    bb_dihedral = torch.stack([omega, phi, psi], dim=-1) * mask_bb_dihed
    return bb_dihedral, mask_bb_dihed


def pairwise_dihedrals(pos_atoms):
    """Inter-residue phi/psi angles (..., L, L, 2)."""
    pos_n = pos_atoms[..., BBHeavyAtom.N, :]
    pos_ca = pos_atoms[..., BBHeavyAtom.CA, :]
    pos_c = pos_atoms[..., BBHeavyAtom.C, :]
    row = lambda x: x[..., :, None, :]
    col = lambda x: x[..., None, :, :]
    ir_phi = dihedral_from_four_points(row(pos_c), col(pos_n), col(pos_ca),
                                       col(pos_c))
    ir_psi = dihedral_from_four_points(row(pos_n), row(pos_ca), row(pos_c),
                                       col(pos_n))
    return torch.stack([ir_phi, ir_psi], dim=-1)
