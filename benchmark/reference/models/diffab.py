"""DiffAb in plain float32 PyTorch: a frozen copy of the port's
``models/diffab.py`` with the encoder's kernel routes taken out. The loss
and the reverse step run the eager GAEncoder over the plain attention of
:mod:`..nn.ipa` and the per-head output modules; every noise draw is an
argument."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..constants import BBHeavyAtom
from ..diffusion import PositionTransition, RotationTransition, SequenceTransition
from ..geometry import (construct_3d_basis, random_uniform_so3,
                        rotation_to_so3vec, so3vec_to_rotation)
from ..nn import EpsilonNet, PairEmbedding, ResidueEmbedding
from . import losses as Ls
from .losses import compute_prmsd, sequence_perplexity


@dataclasses.dataclass(frozen=True)
class DiffAbConfig:
    res_feat_dim: int = 128
    pair_feat_dim: int = 64
    num_steps: int = 100
    num_layers: int = 6
    obj: str = 'pred_x0'               # 'pred_x0' | 'pred_noise'
    num_atoms: int = 15
    num_bins: int = 40
    dist_min: float = 0.5
    dist_max: float = 19.5
    train_structure: bool = True
    train_sequence: bool = True
    position_mean: Tuple[float, ...] = (0.0, 0.0, 0.0)
    position_scale: Tuple[float, ...] = (10.0,)
    mask_ratio_min: float = 0.0        # random partial-CDR masking (0 = off)
    mask_ratio_max: float = 0.0
    dtype: str = 'float32'             # compute dtype for dense layers

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == 'bfloat16' else torch.float32

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> 'DiffAbConfig':
        """Build from a reference-style config dict (the model section);
        keys the port has no field for are dropped."""
        d = dict(d)
        d.pop('type', None)
        diffusion = d.pop('diffusion', {})
        kw = {'num_atoms': 15 if d.pop('resolution', 'full') == 'full' else 5}
        fields = {f.name for f in dataclasses.fields(cls)}
        for src in (d, diffusion):
            for k, v in src.items():
                if k == 'eps_net_opt':
                    kw['num_layers'] = v.get('num_layers', 6)
                elif k in fields:
                    kw[k] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)


class _Diffusion(nn.Module):
    """Holds the denoiser under the reference's ``diffusion.eps_net`` name."""

    def __init__(self, eps_net: EpsilonNet):
        super().__init__()
        self.eps_net = eps_net


class DiffAbNet(nn.Module):
    """Embeddings + denoiser."""

    def __init__(self, cfg: DiffAbConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.residue_embed = ResidueEmbedding(cfg.res_feat_dim, cfg.num_atoms,
                                              dtype=dt)
        self.pair_embed = PairEmbedding(cfg.pair_feat_dim, cfg.num_atoms,
                                        dtype=dt)
        self.diffusion = _Diffusion(EpsilonNet(
            cfg.res_feat_dim, cfg.pair_feat_dim, cfg.num_layers,
            num_bins=cfg.num_bins, dtype=dt))

    @property
    def eps_net(self) -> EpsilonNet:
        return self.diffusion.eps_net

    def encode(self, batch, remove_structure: bool, remove_sequence: bool):
        """Residue/pair features + frames with leak-proof context masks."""
        context_mask = (batch['mask_heavyatom'][:, :, BBHeavyAtom.CA]
                        & ~batch['generate_flag'])
        structure_mask = context_mask if remove_structure else None
        sequence_mask = context_mask if remove_sequence else None
        pos = batch['pos_heavyatom'].float()
        res_feat = self.residue_embed(
            aa=batch['aa'], res_nb=batch['res_nb'], chain_nb=batch['chain_nb'],
            pos_atoms=pos, mask_atoms=batch['mask_heavyatom'],
            fragment_type=batch['fragment_type'],
            structure_mask=structure_mask, sequence_mask=sequence_mask)
        pair_feat = self.pair_embed(
            aa=batch['aa'], res_nb=batch['res_nb'], chain_nb=batch['chain_nb'],
            pos_atoms=pos, mask_atoms=batch['mask_heavyatom'],
            structure_mask=structure_mask, sequence_mask=sequence_mask)
        R = construct_3d_basis(pos[:, :, BBHeavyAtom.CA],
                               pos[:, :, BBHeavyAtom.C],
                               pos[:, :, BBHeavyAtom.N])
        return res_feat, pair_feat, R, pos[:, :, BBHeavyAtom.CA]


class DiffAb(DiffAbNet):
    """Parameters + transitions + training losses + reverse-diffusion
    sampling. ``cfg`` may also be a config dict's model section (read by
    :meth:`DiffAbConfig.from_dict`), as :func:`get_model` passes it."""

    def __init__(self, cfg: DiffAbConfig):
        if isinstance(cfg, dict):
            cfg = DiffAbConfig.from_dict(cfg)
        super().__init__(cfg)
        self.trans_rot = RotationTransition(cfg.num_steps)
        self.trans_pos = PositionTransition(cfg.num_steps)
        self.trans_seq = SequenceTransition(cfg.num_steps)

    def _position_affine(self, ref):
        as_t = lambda v: torch.tensor(v, dtype=torch.float32,
                                      device=ref.device).reshape(1, 1, -1)
        return as_t(self.cfg.position_mean), as_t(self.cfg.position_scale)

    def normalize_position(self, p):
        mean, scale = self._position_affine(p)
        return (p - mean) / scale

    def unnormalize_position(self, p):
        mean, scale = self._position_affine(p)
        return p * scale + mean

    def loss_draws(self, N: int, L: int, generator=None, device='cpu'):
        """(t, draws) of one :meth:`loss` call on an (N, L) batch
        (``losses.loss_draws``: the trainer draws them for the global batch
        and each rank keeps its rows)."""
        cfg = self.cfg
        return Ls.loss_draws(
            N, L, cfg.num_steps, generator, device,
            sequence=cfg.train_sequence,
            mask_ratio=((cfg.mask_ratio_min, cfg.mask_ratio_max)
                        if cfg.mask_ratio_min > 0 else None))

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Single-step diffusion training losses: {'prmsd', 'dist' (with
        ``obj='pred_x0'``), 'rot', 'pos', 'seq'}, each a scalar.

        ``t`` (N,) timesteps in [0, num_steps) (else drawn). ``draws``
        optionally supplies every noise draw (else ``generator`` draws
        them): 'rot_axis' (N, L, 3), 'rot_u', 'rot_frac', 'rot_gauss'
        (N, L), 'pos' (N, L, 3), 'seq_gumbel' (N, L, 20), and 'mask_keep'
        (N, L) bool when ``mask_ratio_min`` > 0.
        """
        cfg = self.cfg
        d = draws or {}
        structure, sequence = cfg.train_structure, cfg.train_sequence
        mask_generate, mask_res = batch['generate_flag'], batch['mask']
        dev = mask_res.device
        if cfg.mask_ratio_min > 0:
            # Random partial-CDR masking: only a Bernoulli subset of the CDR
            # is generated this step.
            keep = d.get('mask_keep')
            if keep is None:
                ratio = cfg.mask_ratio_min + (
                    cfg.mask_ratio_max - cfg.mask_ratio_min) * torch.rand(
                        (), generator=generator, device=dev)
                keep = torch.rand(mask_generate.shape, generator=generator,
                                  device=dev) < ratio
            mask_generate = mask_generate & keep
            batch = dict(batch, generate_flag=mask_generate)

        res_feat, pair_feat, R_0, p_0 = self.encode(batch, structure, sequence)
        v_0 = rotation_to_so3vec(R_0)
        s_0 = batch['aa'].long()
        if t is None:
            t = torch.randint(0, cfg.num_steps, (s_0.shape[0],),
                              generator=generator, device=dev)
        t = t.to(dev).long()
        p_0 = self.normalize_position(p_0)
        self.trans_rot.to(dev)

        if structure:
            v_noisy, _ = self.trans_rot.add_noise(
                v_0, mask_generate, t, axis=d.get('rot_axis'),
                u=d.get('rot_u'), frac=d.get('rot_frac'),
                gauss=d.get('rot_gauss'), generator=generator)
            p_noisy, _ = self.trans_pos.add_noise(
                p_0, mask_generate, t, eps=d.get('pos'), generator=generator)
        else:
            v_noisy, p_noisy = v_0, p_0
        s_noisy = s_0
        if sequence:
            _, s_noisy = self.trans_seq.add_noise(
                s_0, mask_generate, t, gumbel=d.get('seq_gumbel'),
                generator=generator)

        beta = torch.as_tensor(self.trans_pos.sched.betas, device=dev)[t]
        _, R_pred, p_pred, c_denoised, prmsd_logits = self.eps_net(
            v_noisy, p_noisy, s_noisy, res_feat, pair_feat, beta,
            mask_generate, mask_res)

        if cfg.obj == 'pred_x0':
            p_true, pred_p0 = p_0, p_pred
        else:
            # As the JAX package (and the reference's dpm_full.py:189):
            # the target is p_noisy and p_0 is passed as the state.
            p_true = p_noisy
            pred_p0 = self.trans_pos.pred_start_from_noise(
                p_0, p_pred, mask_generate, t)

        losses = {}
        rmsd = Ls.masked_rmsd(self.unnormalize_position(pred_p0),
                              self.unnormalize_position(p_0), mask_generate)
        # Per-complex mask "has any generated residue" (the semantic mask of
        # the JAX package, not the reference's positional one).
        losses['prmsd'] = Ls.prmsd_loss(
            prmsd_logits, rmsd.detach(), mask_generate.any(-1),
            cfg.dist_min, cfg.dist_max, cfg.num_bins)
        if cfg.obj == 'pred_x0':
            losses['dist'] = Ls.pairwise_distance_loss(
                p_pred, p_true, mask_generate, mask_res)
        losses['rot'] = Ls.masked_mean(Ls.rotation_matrix_cosine_loss(
            R_pred, so3vec_to_rotation(v_0)), mask_generate)
        losses['pos'] = Ls.masked_mean(((p_pred - p_true) ** 2).sum(-1),
                                       mask_generate)
        post_true = self.trans_seq.posterior(s_noisy, s_0, t)
        log_post_pred = torch.log(
            self.trans_seq.posterior(s_noisy, c_denoised, t) + 1e-8)
        losses['seq'] = Ls.sequence_kl_loss(post_true, log_post_pred,
                                            mask_generate)
        return losses

    def initial_state(self, batch, draws=None, num_replicas: int = 1,
                      sample_structure: bool = True,
                      sample_sequence: bool = True, generator=None):
        """The features and the state the port's ``DiffAb.sample`` starts
        its reverse loop from: (v, p normalized, s, res_feat, pair_feat,
        mask_generate, mask_res), the rows tiled ``num_replicas`` times a
        complex; ``draws`` as that method's ('init_quat', 'init_pos',
        'init_seq')."""
        draws = draws or {}
        reps = num_replicas
        mask_generate = batch['generate_flag']
        mask_res = batch['mask']
        res_feat, pair_feat, R_0, p_ctx = self.encode(
            batch, sample_structure, sample_sequence)
        aa = batch['aa']
        if reps > 1:
            rep = lambda x: x.repeat_interleave(reps, dim=0)
            res_feat, R_0, p_ctx, mask_generate, mask_res, aa = map(
                rep, (res_feat, R_0, p_ctx, mask_generate, mask_res, aa))
        v = rotation_to_so3vec(R_0)
        p = self.normalize_position(p_ctx)
        s = aa.long()
        N, L = s.shape
        dev = s.device
        gen3 = mask_generate[..., None]
        if sample_structure:
            v_rand = random_uniform_so3((N, L), generator, dev,
                                        normal=draws.get('init_quat'))
            p_rand = draws.get('init_pos')
            if p_rand is None:
                p_rand = torch.randn(p.shape, generator=generator, device=dev)
            v = torch.where(gen3, v_rand, v)
            p = torch.where(gen3, p_rand, p)
        if sample_sequence:
            s_rand = draws.get('init_seq')
            if s_rand is None:
                s_rand = torch.randint(0, 19, s.shape, generator=generator,
                                       device=dev)
            s = torch.where(mask_generate, s_rand.long(), s)
        return v, p, s, res_feat, pair_feat, mask_generate, mask_res

    def reverse_step(self, v, p, s, t: int, res_feat, pair_feat,
                     mask_generate, mask_res, reps: int = 1,
                     draws: Optional[Dict] = None, generator=None,
                     sample_structure: bool = True,
                     sample_sequence: bool = True,
                     t_next: Optional[int] = None,
                     with_posterior: bool = False):
        """One reverse step from state (v, p normalized, s) at level t:
        ancestral t -> t-1, or with ``t_next`` a strided jump t -> t_next
        (rotations re-noised at t_next, positions by DDIM, sequences by the
        ancestral step at t), through the eager encoder and the per-head
        modules. ``draws`` is one step's entry of the port's
        ``DiffAb.sample`` draws. Returns (v, p, s, prmsd, perplexity), and
        with ``with_posterior`` the sequence posterior (N, L, 20) last."""
        cfg = self.cfg
        d = draws or {}
        beta = torch.full((s.shape[0],), float(self.trans_pos.sched.betas[t]),
                          device=p.device)
        v_next, _, p_pred, c_denoised, prmsd_logits = self.eps_net(
            v, p, s, res_feat, pair_feat, beta, mask_generate, mask_res,
            reps=reps)
        if cfg.obj == 'pred_x0':
            eps_p = self.trans_pos.pred_noise_from_start(p, p_pred,
                                                         mask_generate, t)
        else:
            eps_p = p_pred
        v_new = self.trans_rot.denoise(
            v, v_next, mask_generate, t if t_next is None else t_next,
            axis=d.get('rot_axis'), u=d.get('rot_u'), frac=d.get('rot_frac'),
            gauss=d.get('rot_gauss'), generator=generator)
        if t_next is None:
            p_new = self.trans_pos.denoise(p, eps_p, mask_generate, t,
                                           z=d.get('pos'), generator=generator)
        else:
            p_new = self.trans_pos.ddim_step(p, eps_p, mask_generate, t,
                                             t_next)
        post, s_new = self.trans_seq.denoise(
            s, c_denoised, mask_generate, t, gumbel=d.get('seq_gumbel'),
            generator=generator)
        if sample_structure:
            v, p = v_new, p_new
        if sample_sequence:
            s = s_new
        out = (v, p, s, compute_prmsd(prmsd_logits, cfg.dist_min,
                                      cfg.dist_max),
               sequence_perplexity(post, mask_generate))
        return out + (post,) if with_posterior else out
