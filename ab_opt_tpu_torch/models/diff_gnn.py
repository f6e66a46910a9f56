"""AbDesign's graph-path co-design model, ``diff_gnn`` (counterpart of
``ab_opt_tpu/models/diff_gnn.py``): dense batched (N, L) tensors with
adjacency masks (:mod:`ab_opt_tpu_torch.nn.egnn`). Per step:

  pseudo-coordinates for the CDR (:func:`interpolate_masked_coords`) ->
  radial ctx/inter adjacency (8 / 12 A) -> residue embedding with hotspot
  conditioning and pair features as dense ctx edge attributes ->
  DenseMCAttEGNN denoises the 3-atom coordinates -> DenseSeqGNN predicts
  the residue types (hydropathy/charge conditioning) -> pred_x0 losses
  {rot, pos, bb_pos, seq, accuracy}, or posterior sampling with
  ``denoise_from_p0`` (DDIM steps when strided).

:class:`DiffGNN` holds the parameters under the reference's state-dict
names (``embed.residue_embed.*``, ``embed.pair_embed.*``, ``gnn.*``,
``seqgnn.*``) and adds the transitions, :meth:`DiffGNN.loss`,
:meth:`DiffGNN.sample` and :meth:`DiffGNN.optimize`. No hand-written kernel
lies on this path: the JAX package computes it as dense masked XLA ops, and
the port as the same PyTorch ops.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..constants import BBHeavyAtom, backbone_atom_coordinates
from ..diffusion import PositionTransition, RotationTransition
from ..geometry import (construct_3d_basis, local_to_global,
                        random_uniform_so3, rotation_to_so3vec,
                        so3vec_to_rotation)
from ..nn import PairEmbedding, ResidueEmbedding
from ..nn.egnn import (NUM_AA_TYPES_OUT, DenseMCAttEGNN, DenseSeqGNN,
                       build_adjacency)
from ..utils.device import DeviceCopies
from . import losses as Ls
from ._base import register_model

# Hydropathy / charge code of a residue with no label (Hydropathy.unknown,
# Charge.unknown), taken when the batch carries no label channel.
_HYD_UNKNOWN, _CHG_UNKNOWN = 3, 4


@dataclasses.dataclass(frozen=True)
class DiffGNNConfig:
    res_feat_dim: int = 128
    edge_feat_dim: int = 128
    hidden_size: int = 128
    num_steps: int = 500
    num_atoms: int = 3                # N, CA, C coordinate channels
    n_layers: int = 6
    dropout: float = 0.1
    dense: bool = False
    hotspot: bool = True
    objective: str = 'pred_x0'
    position_mean: Tuple[float, ...] = (0.0,)
    position_scale: Tuple[float, ...] = (10.0,)
    train_structure: bool = True
    train_sequence: bool = True
    ctx_cutoff: float = 8.0
    inter_cutoff: float = 12.0
    dtype: str = 'float32'

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == 'bfloat16' else torch.float32

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> 'DiffGNNConfig':
        d = dict(d)
        d.pop('type', None)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in d.items() if k in fields}
        return cls(**kw)


def interpolate_masked_coords(coord, generate_flag, mask):
    """Pseudo-coordinates for the span to generate: linear interpolation
    between its flanking anchors. A row with nothing to generate has start
    L and end -1, both anchors clipped into [0, L-1], as in JAX.

    coord: (N, L, C, 3); generate_flag/mask: (N, L).
    """
    N, L = generate_flag.shape
    idx = torch.arange(L, device=coord.device)
    start = torch.where(generate_flag, idx[None], L).amin(1)            # (N,)
    end = torch.where(generate_flag, idx[None], -1).amax(1)
    left = torch.clamp(start - 1, 0, L - 1)
    right = torch.clamp(end + 1, 0, L - 1)
    rows = torch.arange(N, device=coord.device)
    l_coord = coord[rows, left][:, None]                           # (N,1,C,3)
    r_coord = coord[rows, right][:, None]
    n_span = (end - start + 2).to(coord.dtype)[:, None, None, None]
    frac = (idx[None] - start[:, None] + 1).to(coord.dtype)
    interp = l_coord + (r_coord - l_coord) * frac[:, :, None, None] / n_span
    return torch.where(generate_flag[:, :, None, None], interp, coord)


class Prepared(NamedTuple):
    """What a call builds once from its batch (JAX's ``_prepare`` tuple):
    normalised coordinates, codes, masks, node features, adjacency, ctx
    edge attributes, the native frames and CA positions, labels."""
    coord_n: torch.Tensor
    aa: torch.Tensor
    gen: torch.Tensor
    mask: torch.Tensor
    res_feat: torch.Tensor
    ctx_adj: torch.Tensor
    inter_adj: torch.Tensor
    ctx_edge_attr: torch.Tensor
    R_0: torch.Tensor
    v_0: torch.Tensor
    p_0: torch.Tensor
    hyd: torch.Tensor
    chg: torch.Tensor

    def repeat(self, reps: int) -> 'Prepared':
        """Every tensor tiled to ``reps`` trajectories a complex
        (contiguous)."""
        return Prepared(*(x.repeat_interleave(reps, dim=0) for x in self))


class _GraphEmbedding(nn.Module):
    """Holds the embeddings under the reference's ``embed`` name."""

    def __init__(self, cfg: DiffGNNConfig):
        super().__init__()
        dt = cfg.compute_dtype
        self.residue_embed = ResidueEmbedding(cfg.res_feat_dim, cfg.num_atoms,
                                              dtype=dt, hotspot=cfg.hotspot)
        self.pair_embed = PairEmbedding(cfg.edge_feat_dim, cfg.num_atoms,
                                        dtype=dt)


@register_model('diff_gnn')
class DiffGNN(nn.Module):
    """Parameters (embeddings, EGNN, sequence head) + transitions + the
    training losses, sampling and optimize. ``cfg`` may also be a config
    dict's model section, as :func:`get_model` passes it."""

    def __init__(self, cfg: DiffGNNConfig):
        super().__init__()
        if isinstance(cfg, dict):
            cfg = DiffGNNConfig.from_dict(cfg)
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.embed = _GraphEmbedding(cfg)
        self.gnn = DenseMCAttEGNN(
            cfg.res_feat_dim, cfg.hidden_size, cfg.hidden_size, cfg.num_atoms,
            in_edge_nf=cfg.edge_feat_dim, n_layers=cfg.n_layers,
            dropout=cfg.dropout, dense=cfg.dense, dtype=dt)
        self.seqgnn = DenseSeqGNN(cfg.hidden_size, cfg.num_atoms,
                                  out_node_nf=NUM_AA_TYPES_OUT,
                                  dropout=cfg.dropout, dtype=dt)
        self.trans_rot = RotationTransition(cfg.num_steps)
        self.trans_pos = PositionTransition(cfg.num_steps)
        self.copies = DeviceCopies({
            'position_mean': cfg.position_mean,
            'position_scale': cfg.position_scale,
            'ideal_bb': backbone_atom_coordinates[0]})

    @property
    def loss_draws_itself(self) -> bool:
        """Whether :meth:`loss`, given ``t`` and ``draws``, still draws of
        its own: its dropout masks, from the loss call's generator, while
        the dropout rate is above 0."""
        return self.cfg.dropout > 0

    def _affine(self, ref):
        as_t = lambda name: self.copies(name, ref.device, torch.float32)
        return as_t('position_mean'), as_t('position_scale')

    def normalize_position(self, p):
        mean, scale = self._affine(p)
        return (p - mean) / scale

    def unnormalize_position(self, p):
        mean, scale = self._affine(p)
        return p * scale + mean

    def _ideal_bb(self, ref):
        """The ideal ALA backbone (N, CA, C), normalised: (3, 3)."""
        _, scale = self._affine(ref)
        return self.copies('ideal_bb', ref.device, torch.float32) / scale

    # ------------------------------------------------------------------ common

    def embed_features(self, batch, remove_structure: bool,
                       remove_sequence: bool):
        """Node + pair features with leak-proof context masks."""
        context_mask = (batch['mask_heavyatom'][:, :, BBHeavyAtom.CA]
                        & ~batch['generate_flag'])
        structure_mask = context_mask if remove_structure else None
        sequence_mask = context_mask if remove_sequence else None
        hotspot = batch.get('hotspot_label') if self.cfg.hotspot else None
        pos = batch['pos_heavyatom'].float()
        res_feat = self.embed.residue_embed(
            aa=batch['aa'], res_nb=batch['res_nb'], chain_nb=batch['chain_nb'],
            pos_atoms=pos, mask_atoms=batch['mask_heavyatom'],
            fragment_type=batch['fragment_type'],
            structure_mask=structure_mask, sequence_mask=sequence_mask,
            hotspot=hotspot)
        pair_feat = self.embed.pair_embed(
            aa=batch['aa'], res_nb=batch['res_nb'], chain_nb=batch['chain_nb'],
            pos_atoms=pos, mask_atoms=batch['mask_heavyatom'],
            structure_mask=structure_mask, sequence_mask=sequence_mask)
        return res_feat, pair_feat

    def denoise(self, h0, noised_coord, ctx_adj, inter_adj, condition,
                ctx_edge_attr, hydropathy, charge, deterministic=True,
                generator=None):
        """The network: (aa logits (N, L, 21), denoised coords z)."""
        out, z, _ = self.gnn(h0, noised_coord, ctx_adj, inter_adj, condition,
                             ctx_edge_attr, deterministic, generator)
        aa_logits = self.seqgnn(out, z, inter_adj, hydropathy, charge,
                                deterministic, generator)
        return aa_logits, z

    def _prepare(self, batch, remove_structure,
                 remove_sequence) -> Prepared:
        """Everything a denoiser evaluation needs that stays fixed across
        steps."""
        cfg = self.cfg
        coord = batch['pos_heavyatom'][:, :, :cfg.num_atoms].float()
        aa, gen = batch['aa'].long(), batch['generate_flag']
        mask = batch['mask']
        masked_coord = interpolate_masked_coords(coord, gen, mask)
        # Edges from the pseudo-coordinates: no leak of generated geometry.
        ctx_adj, inter_adj = build_adjacency(
            masked_coord[:, :, BBHeavyAtom.CA], batch['fragment_type'], mask,
            cfg.ctx_cutoff, cfg.inter_cutoff)
        res_feat, pair_feat = self.embed_features(batch, remove_structure,
                                                  remove_sequence)
        # Pair features become dense ctx edge attributes.
        ctx_edge_attr = pair_feat * ctx_adj[..., None]

        coord_n = self.normalize_position(coord)
        R_0 = construct_3d_basis(coord_n[..., BBHeavyAtom.CA, :],
                                 coord_n[..., BBHeavyAtom.C, :],
                                 coord_n[..., BBHeavyAtom.N, :])
        v_0 = rotation_to_so3vec(R_0)
        p_0 = coord_n[..., BBHeavyAtom.CA, :]
        hyd = batch.get('hydropathy')
        if hyd is None:
            hyd = torch.full_like(aa, _HYD_UNKNOWN)
        chg = batch.get('charge')
        if chg is None:
            chg = torch.full_like(aa, _CHG_UNKNOWN)
        return Prepared(coord_n, aa, gen, mask, res_feat, ctx_adj, inter_adj,
                        ctx_edge_attr, R_0, v_0, p_0, hyd.long(), chg.long())

    def _noised_coord(self, coord_n, p_t, v_t, gen):
        """The ideal ALA N/CA/C placed by the noisy frame on generated
        residues."""
        bb = self._ideal_bb(p_t).expand(coord_n.shape[:2] + (3, 3))
        recon = local_to_global(so3vec_to_rotation(v_t), p_t, bb)
        return torch.where(gen[:, :, None, None], recon, coord_n)

    def _denoiser(self, state, prep: Prepared, generator=None,
                  deterministic=True):
        """(aa logits, z, R_pred, p_pred) at state (v_t, p_t, t): ``t`` an
        int (sampling) or an (N, L) tensor (training)."""
        gen, mask = prep.gen, prep.mask
        v_t, p_t, t = state
        noised_coord = self._noised_coord(prep.coord_n, p_t, v_t, gen)
        betas = self.trans_pos.sched.betas
        if torch.is_tensor(t):
            condition = self.trans_pos.sched.copies(
                'betas', gen.device)[t.long()]
        else:
            condition = torch.full(gen.shape, float(betas[t]),
                                   device=gen.device)
        aa_logits, z = self.denoise(prep.res_feat, noised_coord, prep.ctx_adj,
                                    prep.inter_adj, condition,
                                    prep.ctx_edge_attr, prep.hyd, prep.chg,
                                    deterministic, generator)
        # Padding rows carry all-zero coordinates, where the frame would
        # normalise a zero vector and a NaN gradient would survive the
        # masked rotation loss: put the ideal backbone there. Their value
        # enters no loss and no sampled output.
        bb = self._ideal_bb(z).expand(z.shape)
        z_safe = torch.where(mask[:, :, None, None], z, bb)
        R_pred = construct_3d_basis(z_safe[..., BBHeavyAtom.CA, :],
                                    z_safe[..., BBHeavyAtom.C, :],
                                    z_safe[..., BBHeavyAtom.N, :])
        return aa_logits, z, R_pred, z[..., BBHeavyAtom.CA, :]

    # ------------------------------------------------------------------- train

    def loss_draws(self, N: int, L: int, generator=None, device='cpu'):
        """(t, draws) of one :meth:`loss` call on an (N, L) batch
        (``losses.loss_draws``); the dropout masks are not among them and
        come from the loss call's generator."""
        return Ls.loss_draws(N, L, self.cfg.num_steps, generator, device,
                             sequence=False)

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Single-step training losses {'rot', 'pos', 'bb_pos', 'seq',
        'accuracy' (detached)}, each a scalar. Dropout is on, with masks
        from ``generator``, in every call (as JAX's loss applies it).

        ``t`` (N,) timesteps in [0, num_steps) (else drawn). ``draws``
        optionally supplies the noise draws (else ``generator`` draws
        them): 'rot_axis' (N, L, 3), 'rot_u', 'rot_frac', 'rot_gauss'
        (N, L) and 'pos' (N, L, 3)."""
        cfg = self.cfg
        d = draws or {}
        prep = self._prepare(batch, cfg.train_structure, cfg.train_sequence)
        aa, gen, v_0, p_0 = prep.aa, prep.gen, prep.v_0, prep.p_0
        N, L = aa.shape
        dev = aa.device
        if t is None:
            t = torch.randint(0, cfg.num_steps, (N,), generator=generator,
                              device=dev)
        t = t.to(dev).long()
        self.trans_rot.to(dev)
        v_noisy, _ = self.trans_rot.add_noise(
            v_0, gen, t, axis=d.get('rot_axis'), u=d.get('rot_u'),
            frac=d.get('rot_frac'), gauss=d.get('rot_gauss'),
            generator=generator)
        p_noisy, _ = self.trans_pos.add_noise(p_0, gen, t, eps=d.get('pos'),
                                              generator=generator)
        aa_logits, z, R_pred, p_pred = self._denoiser(
            (v_noisy, p_noisy, t[:, None].expand(N, L)), prep, generator,
            deterministic=False)

        gm = gen & prep.mask
        losses = {}
        losses['rot'] = Ls.masked_mean(
            Ls.rotation_matrix_cosine_loss(R_pred, prep.R_0), gm)
        losses['pos'] = Ls.masked_mean(((p_pred - p_0) ** 2).sum(-1), gm)
        losses['bb_pos'] = Ls.masked_mean(
            ((z - prep.coord_n) ** 2).sum(-1).mean(-1), gm)
        logp = torch.log_softmax(aa_logits, dim=-1)
        # Padding rows carry aa=21, past the 21 classes: clamp before the
        # gather.
        aa_safe = torch.clamp(aa, 0, aa_logits.shape[-1] - 1)
        ce = -logp.gather(-1, aa_safe[..., None])[..., 0]
        losses['seq'] = Ls.masked_mean(ce, gm)
        acc = (aa_logits.argmax(-1) == aa).float()
        losses['accuracy'] = Ls.masked_mean(acc, gm).detach()
        return losses

    # ------------------------------------------------------------------ sample

    @torch.no_grad()
    def sample(self, batch, generator: Optional[torch.Generator] = None,
               sample_structure: bool = True, sample_sequence: bool = True,
               keep_traj: bool = False, num_replicas: int = 1,
               stride: int = 1, draws: Optional[Dict] = None):
        """Reverse diffusion from noise with trajectory fan-out: features
        and edges are built once on ``batch``, then tiled to
        ``num_replicas`` trajectories a complex (contiguous). ``stride`` > 1
        jumps t -> max(t - stride, 0) with DDIM position steps.

        ``draws`` optionally supplies every noise draw (else ``generator``
        draws them): 'init_quat' (N, L, 4) and 'init_pos' (N, L, 3)
        standard normals, and 'steps', one dict a reverse step with
        'rot_axis' (N, L, 3), 'rot_u', 'rot_frac', 'rot_gauss' (N, L) and
        'pos' (N, L, 3). Returns 'v', 'p' (unnormalised), 's'; with
        ``keep_traj`` also 'traj', the state after every step, each
        (steps, N, ...)."""
        d = draws or {}
        prep = self._prepare(batch, sample_structure, sample_sequence)
        if num_replicas > 1:
            prep = prep.repeat(num_replicas)
        aa, gen, v_0, p_0 = prep.aa, prep.gen, prep.v_0, prep.p_0
        N, L = aa.shape
        dev = aa.device
        v, p = v_0, p_0
        if sample_structure:
            v_rand = random_uniform_so3((N, L), generator, dev,
                                        normal=d.get('init_quat'))
            p_rand = d.get('init_pos')
            if p_rand is None:
                p_rand = torch.randn(p_0.shape, generator=generator,
                                     device=dev)
            v = torch.where(gen[..., None], v_rand, v_0)
            p = torch.where(gen[..., None], p_rand.to(dev), p_0)
        return self._reverse_loop(v, p, aa, prep, self.cfg.num_steps,
                                  sample_structure,
                                  sample_sequence, keep_traj, stride,
                                  generator, d.get('steps'))

    @torch.no_grad()
    def optimize(self, batch, opt_step: int,
                 generator: Optional[torch.Generator] = None,
                 sample_structure: bool = True, sample_sequence: bool = True,
                 keep_traj: bool = False, draws: Optional[Dict] = None):
        """Noise the native state of the generated span to ``opt_step``,
        then denoise from there; the sequence is re-predicted along the way
        (the graph model has no sequence diffusion). One trajectory a row
        of ``batch``. ``draws`` as :meth:`loss`'s for the noising, plus
        'steps' as :meth:`sample`'s. Returns what :meth:`sample`
        returns."""
        d = draws or {}
        prep = self._prepare(batch, sample_structure, sample_sequence)
        aa, gen, v, p = prep.aa, prep.gen, prep.v_0, prep.p_0
        if sample_structure:
            t_vec = torch.full((aa.shape[0],), opt_step, dtype=torch.long,
                               device=aa.device)
            self.trans_rot.to(aa.device)
            v, _ = self.trans_rot.add_noise(
                v, gen, t_vec, axis=d.get('rot_axis'), u=d.get('rot_u'),
                frac=d.get('rot_frac'), gauss=d.get('rot_gauss'),
                generator=generator)
            p, _ = self.trans_pos.add_noise(p, gen, t_vec, eps=d.get('pos'),
                                            generator=generator)
        return self._reverse_loop(v, p, aa, prep, opt_step,
                                  sample_structure, sample_sequence,
                                  keep_traj, 1, generator, d.get('steps'))

    def reverse_step(self, v, p, s, t: int, prep: Prepared, draws=None,
                     generator=None, sample_structure: bool = True,
                     sample_sequence: bool = True,
                     t_next: Optional[int] = None):
        """One reverse step from state (v, p normalised, s) at level t:
        the posterior-mean step t -> t-1, or with ``t_next`` a strided jump
        (rotations re-noised at t_next, positions by DDIM). ``prep`` is
        :meth:`_prepare`'s output at the state's fan-out; ``draws`` one
        step's entry of :meth:`sample`'s draws. Returns (v, p, s)."""
        d = draws or {}
        gen = prep.gen
        aa_logits, _, R_pred, p0_pred = self._denoiser((v, p, t), prep)
        v_next = rotation_to_so3vec(R_pred)
        rot = dict(axis=d.get('rot_axis'), u=d.get('rot_u'),
                   frac=d.get('rot_frac'), gauss=d.get('rot_gauss'),
                   generator=generator)
        if t_next is None:
            v_new = self.trans_rot.denoise(v, v_next, gen, t, **rot)
            p_new = self.trans_pos.denoise_from_p0(
                p, p0_pred, gen, t, z=d.get('pos'), generator=generator)
        else:
            v_new = self.trans_rot.denoise(v, v_next, gen, t_next, **rot)
            eps_p = self.trans_pos.pred_noise_from_start(p, p0_pred, gen, t)
            p_new = self.trans_pos.ddim_step(p, eps_p, gen, t, t_next)
        if sample_structure:
            v, p = v_new, p_new
        if sample_sequence:
            s = torch.where(gen, aa_logits.argmax(-1), s)
        return v, p, s

    def _reverse_loop(self, v, p, s, prep: Prepared, t_start: int,
                      sample_structure: bool, sample_sequence: bool,
                      keep_traj: bool, stride: int, generator, step_draws):
        """Steps t = t_start, t_start - stride, ... > 0, each to
        max(t - stride, 0) (every step of a strided loop a strided step),
        positions normalised inside."""
        self.trans_rot.to(p.device)
        traj = {'v': [], 'p': [], 's': []}
        for step, t in enumerate(range(t_start, 0, -stride)):
            v, p, s = self.reverse_step(
                v, p, s, t, prep, step_draws[step] if step_draws else None,
                generator, sample_structure, sample_sequence,
                None if stride == 1 else max(t - stride, 0))
            if keep_traj:
                for k, x in (('v', v), ('p', self.unnormalize_position(p)),
                             ('s', s)):
                    traj[k].append(x)
        out = {'v': v, 'p': self.unnormalize_position(p), 's': s}
        if keep_traj:
            out['traj'] = {k: torch.stack(x) for k, x in traj.items()}
        return out
