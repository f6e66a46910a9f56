"""The DiffAb sequence-structure co-design model: the training losses,
reverse-diffusion sampling with trajectory fan-out (ancestral or strided)
and the optimize path (noise the native state to a step, then denoise).

Counterpart of ``ab_opt_tpu/models/diffab.py`` (``loss``, ``sample``,
``optimize``). :class:`DiffAbNet` holds the parameters under the
reference's state-dict names (``residue_embed.*``, ``pair_embed.*``,
``diffusion.eps_net.*``); :class:`DiffAb` adds the transitions,
:meth:`DiffAb.loss`, :meth:`DiffAb.sample` and :meth:`DiffAb.optimize`.

The loss runs the eager GAEncoder, whose attention goes through the K2/K3
kernels under autograd (:mod:`ab_opt_tpu_torch.ops.ipa_attention`), and
the per-head output modules.

The reverse loop is a Python loop over t (a Python int inside the step).
What stays fixed across steps is built once per call: the per-layer pair
biases, the GABlock kernel weight bundles and the stacked head weights.
``DiffAbConfig.ipa_impl`` picks the encoder's route, as in the JAX
package: ``'auto'`` and ``'pallas_fused'`` run every layer through
:func:`ab_opt_tpu_torch.ops.gablock.gablock_layer` (K1), or, with the
environment variable ``AB_OPT_FUSED_CHAIN`` set to anything but ``'0'``
and more than one layer, the whole encoder of a step through one
:func:`ab_opt_tpu_torch.ops.gablock.fused_encoder_chained` call (K5);
``'pallas'`` runs
the eager GAEncoder in its sampling form, whose attention is
:func:`ab_opt_tpu_torch.ops.ipa_attention.ipa_attention_fwd_p2n` (K4), as
does ``'auto'`` on the card for a crop longer than K1 takes
(:func:`encoder_route`). Each is the Hopper kernel for CUDA tensors, its
plain version for CPU tensors. On the card the K1 and K4 routes replay
each reverse step as a CUDA graph (:mod:`.step_graph`).
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..constants import BBHeavyAtom
from ..diffusion import (PositionTransition, RotationTransition,
                         SequenceTransition, gumbel_noise)
from ..geometry import (construct_3d_basis, random_uniform_so3,
                        rotation_to_so3vec, so3vec_to_rotation)
from ..nn import EpsilonNet, PairEmbedding, ResidueEmbedding
from ..nn.epsilon_net import precompute_head_weights
from ..nn.ipa import precompute_encoder_pair_biases
from ..ops.gablock import MAX_L as FUSED_MAX_L
from ..ops.gablock import (attention_plan, attention_replicas,
                           build_encoder_weights, fused_encoder_chained,
                           gablock_layer, stack_encoder_weights)
from ..ops.ipa_attention import ipa_attention_fwd_p2n
from ..utils.device import DeviceCopies
from ..utils.profiling import span
from . import losses as Ls
from ._base import register_model
from .losses import compute_prmsd, sequence_perplexity
from .step_graph import GRAPH_ROUTES, ShapeGraphs, StepGraphs


# The sampler's encoder routes: the per-layer GABlock kernel (K1), or the
# chained whole-encoder kernel (K5) under AB_OPT_FUSED_CHAIN, for 'auto'
# and 'pallas_fused'; the eager GAEncoder over the attention kernel
# with in-kernel pair aggregation (K4) for 'pallas', and for 'auto' on the
# card past FUSED_MAX_L (see encoder_route).
IPA_IMPLS = ('auto', 'pallas_fused', 'pallas')
# FUSED_MAX_L, the longest crop K1 and K5 take: the JAX package has no
# fused-layer plan past it either, its working-set model at L=320 and one
# replica a cell being ~31.9 MB against the 24 MB scoped-VMEM budget
# (ab_opt_tpu/ops/gablock_pallas.py::_vmem_estimate_bytes).

logger = logging.getLogger(__name__)

# The request id of a sampler call's spans: a count of this process's
# DiffAb.sample and DiffAb.optimize calls.
_REQUESTS = itertools.count()


def encoder_route(ipa_impl: str, is_cuda: bool, L: int, chain: bool) -> str:
    """The kernel the sampler's encoder runs through, a pure function of
    the config's ``ipa_impl``, whether the operands lie on the card, the
    crop length ``L`` and whether ``AB_OPT_FUSED_CHAIN`` asks for the
    chained encoder (``chain``; taken with more than one layer): ``'k1'``
    (one GABlock launch a layer), ``'k5'`` (the whole encoder in one
    launch) or ``'k4'`` (the eager GAEncoder over the attention kernel with
    the pair aggregation). On the CPU each wrapper takes its plain version.

    ``'auto'`` on the card past ``FUSED_MAX_L`` takes K4, which runs its
    CUDA-core tiles at any L up to 512; on the CPU ``'auto'`` keeps K1's
    (or K5's) plain version at any L. ``'pallas_fused'`` past
    ``FUSED_MAX_L`` raises: no fused-layer plan fits there."""
    if ipa_impl == 'pallas' or (ipa_impl == 'auto' and is_cuda
                                and L > FUSED_MAX_L):
        return 'k4'
    if ipa_impl == 'pallas_fused' and L > FUSED_MAX_L:
        raise ValueError(
            f"ipa_impl='pallas_fused' at L={L}: the fused GABlock kernels "
            f"(K1, K5) take L up to {FUSED_MAX_L}; use ipa_impl='auto', "
            f"which takes the K4 route past {FUSED_MAX_L} on the card, or "
            f"'pallas'")
    return 'k5' if chain else 'k1'


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
    ipa_impl: str = 'auto'             # sampler's encoder route: IPA_IMPLS

    def __post_init__(self):
        if self.ipa_impl not in IPA_IMPLS:
            raise ValueError(f'ipa_impl={self.ipa_impl!r}: the port takes '
                             f'{", ".join(map(repr, IPA_IMPLS))}')

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


@register_model('diffab')
class DiffAb(DiffAbNet):
    """Parameters + transitions + training losses + reverse-diffusion
    sampling. ``cfg`` may also be a config dict's model section (read by
    :meth:`DiffAbConfig.from_dict`), as :func:`get_model` passes it."""

    # Given ``t`` and ``draws`` (:meth:`loss_draws`), :meth:`loss` draws
    # nothing of its own: the trainer may capture its step as a CUDA graph.
    loss_draws_itself = False

    def __init__(self, cfg: DiffAbConfig):
        if isinstance(cfg, dict):
            cfg = DiffAbConfig.from_dict(cfg)
        super().__init__(cfg)
        self.trans_rot = RotationTransition(cfg.num_steps)
        self.trans_pos = PositionTransition(cfg.num_steps)
        self.trans_seq = SequenceTransition(cfg.num_steps)
        self.step_graphs = StepGraphs()
        self.copies = DeviceCopies({'position_mean': cfg.position_mean,
                                    'position_scale': cfg.position_scale})

    def _position_affine(self, ref):
        as_t = lambda name: self.copies(name, ref.device,
                                        torch.float32).reshape(1, 1, -1)
        return as_t('position_mean'), as_t('position_scale')

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
             t: Optional[torch.Tensor] = None, draws: Optional[Dict] = None,
             attention=None) -> Dict[str, torch.Tensor]:
        """Single-step diffusion training losses: {'prmsd', 'dist' (with
        ``obj='pred_x0'``), 'rot', 'pos', 'seq'}, each a scalar.

        ``t`` (N,) timesteps in [0, num_steps) (else drawn). ``draws``
        optionally supplies every noise draw (else ``generator`` draws
        them): 'rot_axis' (N, L, 3), 'rot_u', 'rot_frac', 'rot_gauss'
        (N, L), 'pos' (N, L, 3), 'seq_gumbel' (N, L, 20), and 'mask_keep'
        (N, L) bool when ``mask_ratio_min`` > 0. ``attention`` replaces the
        encoder's attention function (the plain version, for a side-by-side
        check on the card).
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

        beta = self.trans_pos.sched.copies('betas', dev)[t]
        _, R_pred, p_pred, c_denoised, prmsd_logits = self.eps_net(
            v_noisy, p_noisy, s_noisy, res_feat, pair_feat, beta,
            mask_generate, mask_res, attention=attention)

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

    @torch.no_grad()
    def sample(self, batch, generator: Optional[torch.Generator] = None,
               sample_structure: bool = True, sample_sequence: bool = True,
               num_replicas: int = 1, draws: Optional[Dict] = None,
               stride: int = 1, keep_traj: bool = False, graph: bool = True):
        """Full reverse-diffusion sampling with trajectory fan-out.

        Encoding runs once on ``batch``; ``num_replicas`` > 1 tiles the
        features to batch * num_replicas independent trajectories while the
        pair tensor stays per complex (shared inside the attention).
        ``stride`` > 1 jumps t -> max(t - stride, 0) (see
        :meth:`reverse_step`).

        ``draws`` optionally supplies every noise draw (else ``generator``
        draws them): 'init_quat' (N, L, 4) and 'init_pos' (N, L, 3) standard
        normals, 'init_seq' (N, L) codes in [0, 19), and 'steps', one dict
        per reverse step with 'rot_axis' (N, L, 3), 'rot_u', 'rot_frac',
        'rot_gauss' (N, L), 'pos' (N, L, 3) and 'seq_gumbel' (N, L, 20).

        Returns final 'v', 'p' (unnormalized), 's' and per-step 'prmsd' and
        'perplexity' (steps, N); with ``keep_traj`` also 'traj', the state
        after every step: 'v', 'p' (unnormalized), 's', each (steps, N, ...).
        ``graph=False`` runs every step eagerly on the card too (for a
        side-by-side check of the CUDA graphs, see :meth:`_reverse_loop`).
        """
        aa = batch['aa']
        with span('sample', request=next(_REQUESTS),
                  N=aa.shape[0] * num_replicas, L=aa.shape[1],
                  **self.sampler_plan(aa, num_replicas, sample_structure,
                                      sample_sequence)):
            draws = draws or {}
            reps = num_replicas
            mask_generate = batch['generate_flag']
            mask_res = batch['mask']
            res_feat, pair_feat, R_0, p_ctx = self.encode(
                batch, sample_structure, sample_sequence)
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
                    p_rand = torch.randn(p.shape, generator=generator,
                                         device=dev)
                v = torch.where(gen3, v_rand, v)
                p = torch.where(gen3, p_rand, p)
            if sample_sequence:
                s_rand = draws.get('init_seq')
                if s_rand is None:
                    s_rand = torch.randint(0, 19, s.shape,
                                           generator=generator, device=dev)
                s = torch.where(mask_generate, s_rand.long(), s)

            return self._reverse_loop(
                v, p, s, res_feat, pair_feat, mask_generate, mask_res,
                self.cfg.num_steps, sample_structure, sample_sequence, reps,
                generator, draws.get('steps'), stride, keep_traj, graph)

    @torch.no_grad()
    def optimize(self, batch, opt_step: int,
                 generator: Optional[torch.Generator] = None,
                 sample_structure: bool = True, sample_sequence: bool = True,
                 keep_traj: bool = False, draws: Optional[Dict] = None,
                 graph: bool = True):
        """Noise the native state to step ``opt_step`` (forward noising at
        t = opt_step for every complex), then denoise opt_step -> 0, one
        trajectory per row of ``batch`` (replicate the batch for more).

        ``draws`` optionally supplies every noise draw, in the JAX order of
        keys (k_rot, k_pos, k_seq, then the loop): 'rot_axis' (N, L, 3),
        'rot_u', 'rot_frac', 'rot_gauss' (N, L) for the rotation noising,
        'pos' (N, L, 3), 'seq_gumbel' (N, L, 20), and 'steps' as in
        :meth:`sample`. Returns what :meth:`sample` returns; ``graph`` as
        there.
        """
        aa = batch['aa']
        with span('sample', request=next(_REQUESTS), N=aa.shape[0],
                  L=aa.shape[1], **self.sampler_plan(
                      aa, 1, sample_structure, sample_sequence)):
            d = draws or {}
            mask_generate, mask_res = batch['generate_flag'], batch['mask']
            res_feat, pair_feat, R_0, p_ctx = self.encode(
                batch, sample_structure, sample_sequence)
            v = rotation_to_so3vec(R_0)
            p = self.normalize_position(p_ctx)
            s = batch['aa'].long()
            t_vec = torch.full((s.shape[0],), opt_step, dtype=torch.long,
                               device=s.device)
            self.trans_rot.to(s.device)
            if sample_structure:
                v, _ = self.trans_rot.add_noise(
                    v, mask_generate, t_vec, axis=d.get('rot_axis'),
                    u=d.get('rot_u'), frac=d.get('rot_frac'),
                    gauss=d.get('rot_gauss'), generator=generator)
                p, _ = self.trans_pos.add_noise(p, mask_generate, t_vec,
                                                eps=d.get('pos'),
                                                generator=generator)
            if sample_sequence:
                _, s = self.trans_seq.add_noise(s, mask_generate, t_vec,
                                                gumbel=d.get('seq_gumbel'),
                                                generator=generator)
            return self._reverse_loop(
                v, p, s, res_feat, pair_feat, mask_generate, mask_res,
                opt_step, sample_structure, sample_sequence, 1, generator,
                d.get('steps'), 1, keep_traj, graph)

    def sampler_route(self, is_cuda: bool, L: int) -> str:
        """The sampler's encoder route (:func:`encoder_route`) for this
        config at crop length ``L``, on the card or not."""
        chain = os.environ.get('AB_OPT_FUSED_CHAIN', '0') != '0'
        return encoder_route(self.cfg.ipa_impl, is_cuda, L,
                             chain and self.cfg.num_layers > 1)

    def sampler_plan(self, aa, reps: int, sample_structure: bool,
                     sample_sequence: bool) -> dict:
        """What a sampler call on the (complexes, L) tokens ``aa``, fanned
        out ``reps`` times a complex, runs, as its ``sample`` span records
        it: ``obj``, the flags (``structure``, ``sequence``), the encoder
        route (``encoder``), ``reps`` and ``heads``, and where K1 runs on
        the card the replicas one attention block serves (``k1_rt``) and
        its attention plan (``ops.gablock.attention_plan``): the
        query rows of a tile (``k1_attn_qt``) and those that hold a residue
        (``k1_attn_rows``). The plain version on the CPU records no plan."""
        L = aa.shape[1]
        plan = {'obj': self.cfg.obj, 'structure': sample_structure,
                'sequence': sample_sequence,
                'encoder': self.sampler_route(aa.is_cuda, L), 'reps': reps,
                'heads': self.eps_net.encoder.blocks[0].dims[0]}
        if plan['encoder'] == 'k1' and aa.is_cuda:
            plan['k1_rt'] = attention_replicas(reps)
            plan['k1_attn_qt'], plan['k1_attn_rows'] = attention_plan(L, reps)
        return plan

    def prepare_denoiser(self, pair_feat, mask_res, reps: int = 1,
                         layer=gablock_layer, attention=ipa_attention_fwd_p2n,
                         chain=fused_encoder_chained):
        """The step-invariant operands of the denoiser, built once per
        sampling call: returns ``(encoder_fn, head_weights)`` for
        :meth:`EpsilonNet.forward`. ``encoder_fn`` runs the encoder by the
        route :func:`encoder_route` picks (logged once a call) with the
        per-layer pair biases (and, for K1 and K5, weight bundles) closed
        over: every GABlock layer through ``layer`` (the K1 wrapper), the
        whole stack in one ``chain`` call (the K5 wrapper) when
        ``AB_OPT_FUSED_CHAIN`` is set to anything but '0' and there is more
        than one layer, as in the JAX package, or the eager GAEncoder in its
        sampling form with ``attention`` (the K4 wrapper), in the compute
        dtype. Each may be given its plain version, for a side-by-side check.

        K1 and K5 take their weight bundles, ``z`` and the pair biases in
        bf16 whatever the compute dtype, as the JAX package builds them for
        its kernel route: whenever that route is taken, i.e. the operands
        lie on a CUDA device or ``ipa_impl`` is ``'pallas_fused'``. The
        ``'auto'`` route on the CPU keeps the compute dtype (JAX's einsum
        off the accelerator). Head weights stay in the compute dtype."""
        route, operands = self.denoiser_operands(pair_feat, mask_res, reps)
        return self.denoiser_from(route, operands, reps, layer, attention,
                                  chain)

    def denoiser_operands(self, pair_feat, mask_res, reps: int = 1):
        """``(route, operands)``: the encoder route (:func:`encoder_route`)
        and the tensors :meth:`prepare_denoiser` closes over, in a dict:
        'heads' (the stacked head weights), 'biases' and 'z', and for K1
        'bundles' and 'mask_f', for K5 'stacked' and 'mask_f' (the biases
        then stacked along a layer axis)."""
        dt = self.cfg.compute_dtype
        encoder = self.eps_net.encoder
        route = self.sampler_route(pair_feat.is_cuda, pair_feat.shape[1])
        logger.info('encoder route %s (ipa_impl=%s, L=%d, %s, %s)', route,
                    self.cfg.ipa_impl, pair_feat.shape[1],
                    pair_feat.device.type, self.cfg.dtype)
        ops = {'heads': precompute_head_weights(self.eps_net, dt)}
        if route == 'k4':
            ops['biases'] = precompute_encoder_pair_biases(
                encoder, pair_feat, mask_res[::reps], dt)
            ops['z'] = pair_feat.to(dt).contiguous()
            return route, ops
        kernel_route = pair_feat.is_cuda or self.cfg.ipa_impl == 'pallas_fused'
        kdt = torch.bfloat16 if kernel_route else dt
        biases = precompute_encoder_pair_biases(encoder, pair_feat,
                                                mask_res[::reps], kdt)
        ops['z'] = pair_feat.to(kdt).contiguous()
        bundles = build_encoder_weights(encoder, kdt)
        ops['mask_f'] = mask_res.float().contiguous()
        if route == 'k5':
            ops['stacked'] = stack_encoder_weights(bundles)
            # (Nc, NL, H, L, L), bf16 on the kernel route.
            ops['biases'] = torch.stack(biases, dim=1).contiguous()
        else:
            ops['bundles'], ops['biases'] = bundles, biases
        return route, ops

    def denoiser_from(self, route: str, ops: dict, reps: int = 1,
                      layer=gablock_layer, attention=ipa_attention_fwd_p2n,
                      chain=fused_encoder_chained):
        """:meth:`prepare_denoiser`'s ``(encoder_fn, head_weights)`` over
        the tensors of :meth:`denoiser_operands`."""
        z, biases = ops['z'], ops['biases']
        if route == 'k4':
            encoder = self.eps_net.encoder

            def encoder_fn(R9, t, x, mask):
                return encoder(R9, t, x, z, mask, reps=reps,
                               attention=attention, pair_biases=biases,
                               fuse_p2n=True)
            return encoder_fn, ops['heads']

        mask_f = ops['mask_f']
        if route == 'k5':
            num_layers, stacked = self.cfg.num_layers, ops['stacked']

            def encoder_fn(R9, t, x, mask):
                return chain(stacked, num_layers, R9.float().contiguous(),
                             t.float().contiguous(), x.float().contiguous(),
                             z, biases, mask_f, reps)

            return encoder_fn, ops['heads']

        def encoder_fn(R9, t, x, mask):
            x = x.float().contiguous()
            R9, t = R9.float().contiguous(), t.float().contiguous()
            for wb, bias in zip(ops['bundles'], biases):
                x = layer(x, R9, t, z, bias, mask_f, wb, reps)
            return x

        return encoder_fn, ops['heads']

    def step_noise(self, shape, t: int, t_next: Optional[int] = None,
                   draws: Optional[Dict] = None, generator=None,
                   device=None) -> Dict[str, torch.Tensor]:
        """Every noise draw of one reverse step on an (N, L) ``shape``
        (:meth:`sample`'s keys of a step): those ``draws`` gives, and the
        rest drawn from ``generator`` in the order and shapes
        :meth:`reverse_step` draws them inline: the rotation's 'rot_axis',
        'rot_u', 'rot_frac' and 'rot_gauss', the ancestral position step's
        'pos' (none at t <= 1 or on a strided step), then 'seq_gumbel'."""
        d = dict(draws or {})
        N, L = shape

        def fill(key, fn, *dims):
            if d.get(key) is None:
                d[key] = fn(dims, generator=generator, device=device)

        fill('rot_axis', torch.randn, N, L, 3)
        fill('rot_u', torch.rand, N, L)
        fill('rot_frac', torch.rand, N, L)
        fill('rot_gauss', torch.randn, N, L)
        if t_next is None and t > 1:
            fill('pos', torch.randn, N, L, 3)
        fill('seq_gumbel', gumbel_noise, N, L, self.trans_seq.num_classes)
        return d

    def reverse_step(self, v, p, s, t: int, res_feat, pair_feat,
                     mask_generate, mask_res, denoiser, reps: int = 1,
                     draws: Optional[Dict] = None, generator=None,
                     sample_structure: bool = True,
                     sample_sequence: bool = True,
                     t_next: Optional[int] = None,
                     graphs: Optional[ShapeGraphs] = None):
        """One reverse step from state (v, p normalized, s) at level t:
        ancestral t -> t-1, or with ``t_next`` a strided jump t -> t_next
        (rotations re-noised at t_next, positions by DDIM, sequences by the
        ancestral step at t, as in the JAX package). ``denoiser`` is
        :meth:`prepare_denoiser`'s output; ``draws`` one step's entry of
        :meth:`sample`'s draws. Returns (v, p, s, prmsd, perplexity).

        ``graphs``, the request shape that :meth:`_reverse_loop` bound on
        the card (:mod:`.step_graph`), holds this call's features, masks
        and denoiser: the step then replays its CUDA graph (captured at the
        level's first step), with the noise drawn ahead
        (:meth:`step_noise`). The ``sample.step`` span's ``graph`` says
        'capture', 'replay' or 'eager'."""
        if graphs is not None:
            with span('sample.step', t=t, graph=graphs.mode(t, t_next)):
                noise = self.step_noise(s.shape, t, t_next, draws,
                                        generator, s.device)
                return graphs.step(self, v, p, s, t, t_next, noise)
        with span('sample.step', t=t, graph='eager'):
            return self.step_body(v, p, s, t, res_feat, mask_generate,
                                  mask_res, denoiser, reps, draws, generator,
                                  sample_structure, sample_sequence, t_next)

    def step_body(self, v, p, s, t: int, res_feat, mask_generate, mask_res,
                  denoiser, reps, draws, generator, sample_structure: bool,
                  sample_sequence: bool, t_next: Optional[int]):
        """:meth:`reverse_step`'s work, eager or under capture."""
        cfg = self.cfg
        d = draws or {}
        encoder_fn, head_weights = denoiser
        beta = torch.full((s.shape[0],),
                          float(self.trans_pos.sched.betas[t]),
                          device=p.device)
        v_next, _, p_pred, c_denoised, prmsd_logits = self.eps_net(
            v, p, s, res_feat, None, beta, mask_generate, mask_res,
            reps=reps, encoder_fn=encoder_fn, head_weights=head_weights)
        if cfg.obj == 'pred_x0':
            eps_p = self.trans_pos.pred_noise_from_start(p, p_pred,
                                                         mask_generate, t)
        else:
            eps_p = p_pred
        v_new = self.trans_rot.denoise(
            v, v_next, mask_generate, t if t_next is None else t_next,
            axis=d.get('rot_axis'), u=d.get('rot_u'),
            frac=d.get('rot_frac'), gauss=d.get('rot_gauss'),
            generator=generator)
        if t_next is None:
            p_new = self.trans_pos.denoise(p, eps_p, mask_generate, t,
                                           z=d.get('pos'),
                                           generator=generator)
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
        return (v, p, s, compute_prmsd(prmsd_logits, cfg.dist_min,
                                       cfg.dist_max),
                sequence_perplexity(post, mask_generate))

    def _reverse_loop(self, v, p, s, res_feat, pair_feat, mask_generate,
                      mask_res, t_start: int, sample_structure: bool,
                      sample_sequence: bool, reps: int, generator, step_draws,
                      stride: int = 1, keep_traj: bool = False,
                      graph: bool = True):
        """t_start -> 0 reverse loop, positions normalized inside; returns
        :meth:`sample`'s dict. Steps t = t_start, t_start - stride, ... > 0,
        each to max(t - stride, 0); every step of a strided loop is a
        strided step. On the card each step replays a CUDA graph
        (:mod:`.step_graph`) on the K1 and K4 routes, unless ``graph`` is
        False; K5's launch carries an epoch the host counts up, which a
        graph would freeze, so its route stays eager."""
        route, operands = self.denoiser_operands(pair_feat, mask_res, reps)
        denoiser = self.denoiser_from(route, operands, reps)
        self.trans_rot.to(p.device)
        graphs = None
        if graph and res_feat.is_cuda and route in GRAPH_ROUTES:
            graphs = self.step_graphs.bind(
                self, route, operands, res_feat, mask_generate, mask_res,
                (v, p, s), reps, (sample_structure, sample_sequence))
        prmsd, ppl, traj = [], [], {'v': [], 'p': [], 's': []}
        for step, t in enumerate(range(t_start, 0, -stride)):
            t_next = None if stride == 1 else max(t - stride, 0)
            v, p, s, score, conf = self.reverse_step(
                v, p, s, t, res_feat, pair_feat, mask_generate, mask_res,
                denoiser, reps, step_draws[step] if step_draws else None,
                generator, sample_structure, sample_sequence, t_next,
                graphs=graphs)
            prmsd.append(score)
            ppl.append(conf)
            if keep_traj:
                for k, x in (('v', v), ('p', self.unnormalize_position(p)),
                             ('s', s)):
                    traj[k].append(x)
        out = {'v': v, 'p': self.unnormalize_position(p), 's': s,
               'prmsd': torch.stack(prmsd), 'perplexity': torch.stack(ppl)}
        if keep_traj:
            out['traj'] = {k: torch.stack(x) for k, x in traj.items()}
        return out
