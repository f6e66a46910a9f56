"""Dense-masked multi-channel EGNN stack, the AbDesign graph path
(counterpart of ``ab_opt_tpu/nn/egnn.py``).

Every graph op is a dense (N, L, L) contraction over an adjacency mask, as
in the JAX package. The modules carry the reference's state-dict names and
layout (``AbDesign/diffab/modules/MCAttGNN/mc_egnn.py``): the edge geometry
is laid out per channel row, ``[rad_c1 (C), dist_c1 (C), rad_c2, ...]``,
and each fused k/v projection interleaves k and v in its output columns
(``k = kv[..., 0::2]``). :func:`ab_opt_tpu_torch.utils.convert.
diff_gnn_params_to_state_dict` maps the JAX package's layout onto this one.

The K=3 coordinate contractions are written as elementwise products and
sums, so they stay exact float32 whatever the TF32 flags are (JAX computes
them at ``Precision.HIGHEST``).

Dropout follows JAX's modules, not ``Module.train()``: each layer takes
``deterministic`` and draws its masks from ``generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .layers import Embedding, Linear

NUM_AA_TYPES_OUT = 21   # 20 aa + UNK (the reference's num_aa_types)


def dropout(x, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None):
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by its
    inverse; the keep mask is drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _dot3(a, b):
    """Sum over a last axis of 3 as explicit float32 products and sums."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def radial_features(x, adj):
    """Edge geometry features.

    Args:
      x: (N, L, C, 3) multi-channel coords; adj: (N, L, L) bool.
    Returns:
      (radial, dist, coord_diff): (N, L, L, C, C) x2 and (N, L, L, C, 3),
      radial and dist L2-normalised per channel pair over every valid edge
      of the whole batch.
    """
    diff = x[:, :, None] - x[:, None]                          # (N,L,L,C,3)
    radial = _dot3(diff[..., :, None, :], diff[..., None, :, :])
    # Channel-pair distances between x_i and x_j (not differences).
    cross = _dot3(x[:, :, None, :, None, :], x[:, None, :, None, :, :])
    sq = _dot3(x, x)                                           # (N,L,C)
    d2 = torch.clamp(sq[:, :, None, :, None] + sq[:, None, :, None, :]
                     - 2.0 * cross, min=1e-12)
    dist = torch.sqrt(d2)

    m = adj[..., None, None].to(radial.dtype)
    norm_r = torch.sqrt(torch.clamp((radial ** 2 * m).sum((0, 1, 2)),
                                    min=1e-24))
    norm_d = torch.sqrt(torch.clamp((dist ** 2 * m).sum((0, 1, 2)),
                                    min=1e-24))
    return radial * m / norm_r, dist * m / norm_d, diff


def _edge_geom(radial, dist):
    """(N, L, L, 2 C^2) in the reference's per-channel-row layout."""
    N, L = radial.shape[:2]
    return torch.cat([radial, dist], dim=-1).reshape(N, L, L, -1)


def _coord_head(hidden_nf: int, n_channel: int, dtype) -> nn.Sequential:
    """Linear, SiLU, bias-free Linear to one weight a channel; the last
    layer starts near zero, as flax's variance_scaling(0.001^2 * 2,
    'fan_avg', 'uniform') starts it."""
    last = Linear(hidden_nf, n_channel, bias=False, dtype=dtype)
    limit = math.sqrt(3.0 * 0.001 ** 2 * 2.0 / ((hidden_nf + n_channel) / 2))
    nn.init.uniform_(last.weight, -limit, limit)
    return nn.Sequential(Linear(hidden_nf, hidden_nf, dtype=dtype), nn.SiLU(),
                         last)


def _attend(q, kv, adj):
    """Masked per-row softmax attention over the k/v columns interleaved
    in ``kv``: returns (agg, alpha, v); a row with no edge gets alpha 0."""
    k, v = kv[..., 0::2], kv[..., 1::2]
    logits = torch.einsum('nif,nijf->nij', q, k)
    logits = torch.where(adj, logits, torch.full_like(logits, -1e9))
    alpha = torch.softmax(logits, dim=-1)
    alpha = torch.where(adj, alpha, torch.zeros_like(alpha))
    return torch.einsum('nij,nijf->nif', alpha, v), alpha, v


class DenseMCEGCL(nn.Module):
    """Multi-channel E(n)-equivariant conv layer over an adjacency mask
    (the reference's MC_E_GCL)."""

    def __init__(self, hidden_nf: int, n_channel: int, edges_in_d: int = 0,
                 residual: bool = True, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.residual = residual
        self.dropout = dropout
        e_in = 2 * hidden_nf + 2 * n_channel ** 2 + edges_in_d
        self.edge_mlp = nn.Sequential(
            Linear(e_in, hidden_nf, dtype=dtype), nn.SiLU(),
            Linear(hidden_nf, hidden_nf, dtype=dtype), nn.SiLU())
        self.coord_mlp = _coord_head(hidden_nf, n_channel, dtype)
        self.node_mlp = nn.Sequential(
            Linear(2 * hidden_nf, hidden_nf, dtype=dtype), nn.SiLU(),
            Linear(hidden_nf, hidden_nf, dtype=dtype))

    def forward(self, h, x, adj, edge_attr=None, deterministic: bool = True,
                generator=None):
        """h: (N, L, F); x: (N, L, C, 3); adj: (N, L, L) bool; edge_attr:
        (N, L, L, E) or None. Returns (h', x')."""
        N, L, Fh = h.shape
        radial, dist, coord_diff = radial_features(x, adj)
        feats = [h[:, :, None].expand(N, L, L, Fh),
                 h[:, None].expand(N, L, L, Fh), _edge_geom(radial, dist)]
        if edge_attr is not None:
            feats.append(edge_attr)
        m = self.edge_mlp(torch.cat(feats, dim=-1))
        m = dropout(m, self.dropout, deterministic, generator)
        m = m * adj[..., None]

        # Coordinate update: mean over neighbours of coord_diff * phi_x(m).
        coord_w = self.coord_mlp(m)
        trans = coord_diff * (coord_w * adj[..., None])[..., None]
        count = torch.clamp(adj.sum(2), min=1).to(x.dtype)
        x = x + trans.sum(2) / count[..., None, None]

        # Node update: summed messages + residual.
        out = self.node_mlp(torch.cat([h, m.sum(2)], dim=-1))
        out = dropout(out, self.dropout, deterministic, generator)
        if self.residual:
            out = h + out
        return out, x


class DenseMCAttention(nn.Module):
    """Cross-segment attention layer over an adjacency mask (the
    reference's MC_Att_L)."""

    def __init__(self, hidden_nf: int, n_channel: int, edges_in_d: int = 0,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.linear_q = Linear(hidden_nf, hidden_nf, dtype=dtype)
        self.linear_kv = Linear(2 * n_channel ** 2 + hidden_nf + edges_in_d,
                                2 * hidden_nf, dtype=dtype)
        self.coord_mlp = _coord_head(hidden_nf, n_channel, dtype)

    def forward(self, h, x, adj, edge_attr=None, deterministic: bool = True,
                generator=None):
        N, L, Fh = h.shape
        radial, dist, coord_diff = radial_features(x, adj)
        feats = [_edge_geom(radial, dist), h[:, None].expand(N, L, L, Fh)]
        if edge_attr is not None:
            feats.append(edge_attr)
        agg, alpha, v = _attend(self.linear_q(h),
                                self.linear_kv(torch.cat(feats, dim=-1)), adj)
        h = h + dropout(agg, self.dropout, deterministic, generator)

        coord_w = self.coord_mlp(v)
        trans = coord_diff * (alpha[..., None] * coord_w)[..., None]
        return h, x + trans.sum(2), alpha


class DenseSeqGNN(nn.Module):
    """Sequence head: attention + hydropathy/charge embeddings -> aa logits
    (the reference's SeqGNN)."""

    def __init__(self, hidden_nf: int, n_channel: int,
                 out_node_nf: int = NUM_AA_TYPES_OUT, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        embed_dim = hidden_nf // 2
        width = hidden_nf + 2 * embed_dim
        self.linear_q = Linear(hidden_nf, hidden_nf, dtype=dtype)
        self.linear_kv = Linear(2 * n_channel ** 2 + hidden_nf,
                                2 * hidden_nf, dtype=dtype)
        self.hydropathy_embed = Embedding(10, embed_dim, dtype=dtype)
        self.charge_embed = Embedding(10, embed_dim, dtype=dtype)
        self.mlp = nn.Sequential(
            Linear(width, width, dtype=dtype), nn.ReLU(),
            Linear(width, width, dtype=dtype), nn.ReLU(),
            Linear(width, out_node_nf, dtype=dtype))

    def forward(self, h, x, adj, hydropathy, charge,
                deterministic: bool = True, generator=None):
        N, L, Fh = h.shape
        radial, dist, _ = radial_features(x, adj)
        kv = self.linear_kv(torch.cat([_edge_geom(radial, dist),
                                       h[:, None].expand(N, L, L, Fh)], -1))
        agg, _, _ = _attend(self.linear_q(h), kv, adj)
        h = h + dropout(agg, self.dropout, deterministic, generator)
        # Code 0 is padding and embeds to zero.
        hyd = self.hydropathy_embed(hydropathy) * (hydropathy > 0)[..., None]
        chg = self.charge_embed(charge) * (charge > 0)[..., None]
        return self.mlp(torch.cat([h, hyd, chg], dim=-1))


class DenseMCAttEGNN(nn.Module):
    """n_layers x (context GCL + inter-segment attention) + time embedding
    + output GCL (the reference's MCAttEGNN)."""

    def __init__(self, in_node_nf: int, hidden_nf: int, out_node_nf: int,
                 n_channel: int, in_edge_nf: int = 0, n_layers: int = 4,
                 dropout: float = 0.1, dense: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        self.dense = dense
        self.linear_in = Linear(in_node_nf, hidden_nf, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f'gcl_{i}', DenseMCEGCL(
                hidden_nf, n_channel, edges_in_d=in_edge_nf, dropout=dropout,
                dtype=dtype))
            self.add_module(f'att_{i}', DenseMCAttention(
                hidden_nf, n_channel, dropout=dropout, dtype=dtype))
        self.time_embedding = Linear(hidden_nf + 3, hidden_nf, dtype=dtype)
        self.out_layer = DenseMCEGCL(hidden_nf, n_channel,
                                     edges_in_d=in_edge_nf, dropout=dropout,
                                     dtype=dtype)
        out_in = hidden_nf * (n_layers + 1) if dense else hidden_nf
        self.linear_out = Linear(out_in, out_node_nf, dtype=dtype)

    def forward(self, h, x, ctx_adj, att_adj, condition, ctx_edge_attr=None,
                deterministic: bool = True, generator=None):
        """h: (N, L, F_in); x: (N, L, C, 3); ctx_adj/att_adj: (N, L, L)
        bool; condition: (N, L) noise level beta a residue. Returns (out,
        x, hidden): per-node outputs, coords, the last hidden state."""
        drop = lambda v: dropout(v, self.dropout, deterministic, generator)
        h = drop(self.linear_in(h))
        states, coords = [], []
        for i in range(self.n_layers):
            h, x = getattr(self, f'gcl_{i}')(h, x, ctx_adj, ctx_edge_attr,
                                             deterministic, generator)
            states.append(h)
            coords.append(x)
            h, x, _ = getattr(self, f'att_{i}')(h, x, att_adj, None,
                                                deterministic, generator)

        t_embed = torch.stack([condition, torch.sin(condition),
                               torch.cos(condition)], dim=-1)
        h = self.time_embedding(torch.cat([h, t_embed], dim=-1))
        h, x = self.out_layer(h, x, ctx_adj, ctx_edge_attr, deterministic,
                              generator)
        hidden = h
        states.append(h)
        coords.append(x)
        if self.dense:
            h = torch.cat(states, dim=-1)
            x = torch.stack(coords).mean(0)
        return self.linear_out(drop(h)), x, hidden


def build_adjacency(ca_pos, fragment_type, mask, ctx_cutoff: float = 8.0,
                    inter_cutoff: float = 12.0):
    """Radial adjacency masks: ctx joins residues of the same fragment
    within ``ctx_cutoff`` A (CA), inter residues of different fragments
    within ``inter_cutoff`` A; no self-loops, no padded residue. The
    squared CA distance is compared with the squared cutoff, as JAX
    compares it."""
    L = mask.shape[1]
    d = ca_pos[:, :, None, :] - ca_pos[:, None, :, :]
    d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
    valid = mask[:, :, None] & mask[:, None, :]
    not_self = ~torch.eye(L, dtype=torch.bool, device=mask.device)[None]
    same_seg = fragment_type[:, :, None] == fragment_type[:, None, :]
    ctx_adj = valid & not_self & same_seg & (d2 <= ctx_cutoff ** 2)
    inter_adj = valid & not_self & ~same_seg & (d2 <= inter_cutoff ** 2)
    return ctx_adj, inter_adj
