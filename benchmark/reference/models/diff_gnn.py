"""AbDesign's graph-path model, ``diff_gnn``: the port's
``models/diff_gnn.py`` (dense batched (N, L) tensors with adjacency
masks) cut to its training loss. Pseudo-coordinates for the CDR ->
radial ctx/inter adjacency (8 / 12 A) -> residue embedding with hotspot
conditioning and pair features as dense ctx edge attributes ->
DenseMCAttEGNN denoises the 3-atom coordinates -> DenseSeqGNN predicts
the residue types -> pred_x0 losses {rot, pos, bb_pos, seq, accuracy}.
Dropout masks come from the loss's generator, in the layers' order."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..constants import BBHeavyAtom, backbone_atom_coordinates
from ..diffusion import PositionTransition, RotationTransition
from ..geometry import (construct_3d_basis, local_to_global,
                        rotation_to_so3vec, so3vec_to_rotation)
from ..nn import PairEmbedding, ResidueEmbedding
from ..nn.egnn import (NUM_AA_TYPES_OUT, DenseMCAttEGNN, DenseSeqGNN,
                       build_adjacency)
from . import losses as Ls

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


class _GraphEmbedding(nn.Module):
    """Holds the embeddings under the reference's ``embed`` name."""

    def __init__(self, cfg: DiffGNNConfig):
        super().__init__()
        dt = cfg.compute_dtype
        self.residue_embed = ResidueEmbedding(cfg.res_feat_dim, cfg.num_atoms,
                                              dtype=dt, hotspot=cfg.hotspot)
        self.pair_embed = PairEmbedding(cfg.edge_feat_dim, cfg.num_atoms,
                                        dtype=dt)


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

    def _affine(self, ref):
        as_t = lambda v: torch.tensor(v, dtype=torch.float32,
                                      device=ref.device)
        return as_t(self.cfg.position_mean), as_t(self.cfg.position_scale)

    def normalize_position(self, p):
        mean, scale = self._affine(p)
        return (p - mean) / scale

    def unnormalize_position(self, p):
        mean, scale = self._affine(p)
        return p * scale + mean

    def _ideal_bb(self, ref):
        """The ideal ALA backbone (N, CA, C), normalised: (3, 3)."""
        _, scale = self._affine(ref)
        return torch.as_tensor(backbone_atom_coordinates[0],
                               dtype=torch.float32, device=ref.device) / scale

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
            condition = torch.as_tensor(betas, device=gen.device)[t.long()]
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
