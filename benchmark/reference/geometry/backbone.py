"""Backbone reconstruction from rigid frames (counterpart of
``ab_opt_tpu/geometry/backbone.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import backbone_atom_coordinates, bb_oxygen_coordinate
from .dihedrals import get_backbone_dihedral_angles
from .frames import compose_rotation_and_translation, local_to_global


def reconstruct_backbone(R, t, aa, chain_nb, res_nb, mask):
    """N/CA/C/O positions (..., L, 4, 3) from frames R (..., L, 3, 3) and
    origins t (..., L, 3)."""
    aa = torch.clamp(aa.long(), 0, 20)
    table = lambda a: torch.as_tensor(a, dtype=R.dtype, device=R.device)
    ideal_bb = table(backbone_atom_coordinates)[aa]          # (..., L, 3, 3)
    ideal_o = table(bb_oxygen_coordinate)[aa]                # (..., L, 3)
    bb_pos = local_to_global(R, t, ideal_bb)

    bb_dihedral, _ = get_backbone_dihedral_angles(bb_pos, chain_nb, res_nb,
                                                  mask)
    psi = bb_dihedral[..., 2]
    sin_psi, cos_psi = torch.sin(psi), torch.cos(psi)
    zero, one = torch.zeros_like(psi), torch.ones_like(psi)
    R_psi = torch.stack([one, zero, zero, zero, cos_psi, -sin_psi,
                         zero, sin_psi, cos_psi], dim=-1
                        ).reshape(psi.shape + (3, 3))
    R_o, t_o = compose_rotation_and_translation(R, t, R_psi,
                                                torch.zeros_like(t))
    o_pos = local_to_global(R_o, t_o, ideal_o[..., None, :])
    return torch.cat([bb_pos, o_pos], dim=-2)


def reconstruct_backbone_partially(pos_ctx, R_new, t_new, aa, chain_nb,
                                   res_nb, mask_atoms, mask_recons):
    """Rebuild the backbone where ``mask_recons`` is set, keep the context
    atoms elsewhere. Returns (pos_new (..., L, A, 3), mask_new (..., L, A))."""
    A = mask_atoms.shape[-1]
    pos_recons = reconstruct_backbone(R_new, t_new, aa, chain_nb, res_nb,
                                      mask_atoms[..., 1])
    pos_recons = F.pad(pos_recons, (0, 0, 0, A - 4))
    pos_new = torch.where(mask_recons[..., None, None], pos_recons, pos_ctx)
    bb_atom = torch.arange(A, device=mask_atoms.device) < 4
    mask_new = torch.where(mask_recons[..., None], bb_atom, mask_atoms)
    return pos_new, mask_new
