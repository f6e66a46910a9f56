"""AlphaFold-style pLDDT confidence head (the port's copy of
``ab_opt_tpu/nn/plddt.py``; dormant in the reference too, which keeps it
out of its denoiser in favour of the pRMSD head): per-residue binned
lddt-CA prediction with a softmax cross-entropy loss and expected-value
decoding."""
from __future__ import annotations

import torch

from .layers import PerResiduePredictor
from .tensor_utils import permute_final_dims


class PerResidueLDDTCaPredictor(PerResiduePredictor):
    """The same LayerNorm + 3-layer MLP head (a semantic alias)."""


def lddt(pred_pos, true_pos, mask, cutoff: float = 15.0, eps: float = 1e-10):
    """lddt-CA score per residue. pred_pos/true_pos: (N, L, 3); mask:
    (N, L, 1). Returns (N, L) in [0, 1]."""
    def dmat(p):
        d2 = ((p[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
        return torch.sqrt(d2 + eps)

    d_true, d_pred = dmat(true_pos), dmat(pred_pos)
    L = pred_pos.shape[1]
    eye = torch.eye(L, dtype=d_true.dtype, device=d_true.device)[None]
    pair_mask = (mask * permute_final_dims(mask, (1, 0))
                 * (d_true < cutoff) * (1.0 - eye))
    dist_l1 = (d_true - d_pred).abs()
    f = d_true.dtype
    score = 0.25 * ((dist_l1 < 0.5).to(f) + (dist_l1 < 1.0).to(f)
                    + (dist_l1 < 2.0).to(f) + (dist_l1 < 4.0).to(f))
    norm = 1.0 / (eps + pair_mask.sum(2))
    return norm * (eps + (pair_mask * score).sum(2))


def compute_plddt(logits):
    """Expected pLDDT in [0, 100] from binned logits."""
    num_bins = logits.shape[-1]
    width = 1.0 / num_bins
    centers = (torch.arange(num_bins, device=logits.device) * width
               + width / 2)
    return (torch.softmax(logits, -1) * centers).sum(-1) * 100.0


def lddt_loss(logits, pred_pos, true_pos, mask, resolution=None,
              cutoff: float = 15.0, eps: float = 1e-10):
    """Binned cross-entropy against the true lddt (the target carries no
    gradient)."""
    num_bins = logits.shape[-1]
    score = lddt(pred_pos, true_pos, mask, cutoff, eps).detach()
    bin_index = torch.clamp(torch.floor(score * num_bins).long(), 0,
                            num_bins - 1)
    target = torch.nn.functional.one_hot(bin_index, num_bins).to(logits.dtype)
    errors = -(target * torch.log_softmax(logits, -1)).sum(-1)
    m = mask[..., 0]
    return (errors * m).sum() / (eps + m.sum())
