"""Training losses and per-step sampling scores (counterpart of
``ab_opt_tpu/models/losses.py``)."""
from __future__ import annotations

import torch

from ..diffusion.transitions import gumbel_noise
from ..nn.layers import distance_to_bins_onehot
from ..parallel.distributed import global_sum


def masked_mean(x, mask, eps: float = 1e-8):
    """Mean of ``x`` over the elements where ``mask`` (same shape) is set.
    Inside ``parallel.distributed.global_batch_sums`` the count is
    the mask's over every rank's rows (no gradient flows through it), so
    each rank returns its share of the global batch's mean."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / (global_sum(mask.sum()) + eps)


def rotation_matrix_cosine_loss(R_pred, R_true):
    """Sum over the three basis columns of (1 - cosine similarity):
    (..., 3, 3) -> (...,)."""
    dot = (R_pred * R_true).sum(-2)
    norm = (torch.linalg.vector_norm(R_pred, dim=-2)
            * torch.linalg.vector_norm(R_true, dim=-2))
    return (1.0 - dot / torch.clamp(norm, min=1e-8)).sum(-1)


def smooth_l1(x, y, beta: float = 1.0):
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def pairwise_distance_loss(p_pred, p_true, mask_generate, mask_res):
    """Masked SmoothL1 between pairwise-distance maps; pair (i, j) counts
    when residue i is generated and both are valid."""
    def cdist(p):
        sq = (p * p).sum(-1)
        cross = torch.einsum('nix,njx->nij', p, p)
        return torch.sqrt(torch.clamp(sq[:, :, None] + sq[:, None, :]
                                      - 2 * cross, min=1e-12))

    mask_map = mask_res[:, :, None] & mask_res[:, None, :]
    mask_pair = mask_generate[:, :, None] & mask_map
    return masked_mean(smooth_l1(cdist(p_pred), cdist(p_true)), mask_pair)


def sequence_kl_loss(post_true, log_post_pred, mask_generate):
    """KL(post_true || post_pred) summed over classes, masked mean over the
    generated residues, with 0 log 0 = 0."""
    xlogx = torch.where(post_true > 0,
                        post_true * torch.log(torch.clamp(post_true, min=1e-30)),
                        torch.zeros_like(post_true))
    kl = (xlogx - post_true * log_post_pred).sum(-1)
    return masked_mean(kl, mask_generate)


def masked_rmsd(pred, target, mask):
    """Per-complex RMSD over the masked residues: (N, L, 3) -> (N,)."""
    m = mask.to(pred.dtype)[..., None]
    sq = ((pred * m - target * m) ** 2).sum(-1)
    n = torch.clamp(mask.sum(-1).to(pred.dtype), min=1.0)
    return torch.sqrt(sq.sum(-1) / n)


def prmsd_loss(prmsd_logits, rmsd, mask, dist_min: float, dist_max: float,
               num_bins: int):
    """Binned cross-entropy of the confidence head: logits (N, bins), rmsd
    (N,), mask (N,)."""
    target = distance_to_bins_onehot(rmsd, dist_min, dist_max, num_bins)
    errors = -(target * torch.log_softmax(prmsd_logits, dim=-1)).sum(-1)
    return masked_mean(errors, mask, eps=1e-10)


def compute_prmsd(prmsd_logits, dist_min: float, dist_max: float):
    """Expected RMSD under the binned confidence head: (N, bins) -> (N,)."""
    bounds = torch.linspace(dist_min, dist_max, prmsd_logits.shape[-1],
                            device=prmsd_logits.device)
    return (torch.softmax(prmsd_logits.float(), dim=-1) * bounds).sum(-1)


def sequence_perplexity(probs, mask_generate):
    """Mean max-probability over generated residues (a confidence score in
    (0, 1], higher = sharper): probs (N, L, K) -> (N,)."""
    max_probs = torch.softmax(probs.float(), dim=-1).amax(-1)
    m = mask_generate.float()
    return (max_probs * m).sum(-1) / torch.clamp(m.sum(-1), min=1e-8)


def loss_draws(N: int, L: int, num_steps: int, generator=None, device='cpu',
               sequence: bool = True, mask_ratio=None):
    """Every random draw of one training-loss call on an (N, L) batch, from
    ``generator`` in a fixed order: ``t`` (N,) and the ``draws`` dict the
    models' ``loss`` takes ('rot_axis' (N, L, 3), 'rot_u', 'rot_frac',
    'rot_gauss' (N, L), 'pos' (N, L, 3); with ``sequence`` 'seq_gumbel'
    (N, L, 20); with ``mask_ratio`` (min, max) 'mask_keep' (N, L), a
    Bernoulli of one ratio drawn in [min, max)). Every entry has the rows
    first, so a rank that draws the global batch's and keeps its rows sees
    the numbers one device would."""
    u = lambda *s: torch.rand(s, generator=generator, device=device)
    n = lambda *s: torch.randn(s, generator=generator, device=device)
    t = torch.randint(0, num_steps, (N,), generator=generator, device=device)
    draws = {'rot_axis': n(N, L, 3), 'rot_u': u(N, L), 'rot_frac': u(N, L),
             'rot_gauss': n(N, L), 'pos': n(N, L, 3)}
    if sequence:
        draws['seq_gumbel'] = gumbel_noise((N, L, 20), generator, device)
    if mask_ratio is not None:
        lo, hi = mask_ratio
        ratio = lo + (hi - lo) * u()
        draws['mask_keep'] = u(N, L) < ratio
    return t, draws
