"""The weight bridge back from flax: DiffAbNet and DiffGNNNet params -> the
port's (and the reference's) torch state dicts.

Inverse of ``ab_opt_tpu/utils/torch_convert.py::convert_diffab_state_dict``
and ``convert_diff_gnn_state_dict``: kernels are transposed back to torch's
(out, in); the planar point layout of the JAX package ([x | y | z] blocks,
head-major inside) goes back to the interleaved (head, point, xyz) layout,
the graph model's edge geometry back to the per-channel-row layout and its
fused k/v projections back to interleaved k/v columns. Takes numpy (or any
array castable with ``np.asarray``) leaves; needs no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _interleave_perm(H: int, P: int) -> np.ndarray:
    """``interleaved[i] = planar[perm[i]]`` (inverse of the planar perm)."""
    perm = np.empty(3 * H * P, np.int64)
    for c in range(3):
        for h in range(H):
            for p in range(P):
                perm[(h * P + p) * 3 + c] = c * H * P + h * P + p
    return perm


def _linear(sd: Dict, prefix: str, p: Mapping, cols=None):
    k = np.asarray(p['kernel'], np.float32)
    if cols is not None:
        k = k[:, cols]
    sd[f'{prefix}.weight'] = _t(k.T)
    if 'bias' in p:
        b = np.asarray(p['bias'], np.float32)
        sd[f'{prefix}.bias'] = _t(b if cols is None else b[cols])


def _mlp(sd: Dict, prefix: str, p: Mapping, torch_indices):
    for i, j in enumerate(torch_indices):
        _linear(sd, f'{prefix}.{j}', p[f'Dense_{i}'])


def _layernorm(sd: Dict, prefix: str, p: Mapping):
    sd[f'{prefix}.gamma'] = _t(p['scale'])
    sd[f'{prefix}.beta'] = _t(p['bias'])


def _ga_block(sd: Dict, prefix: str, p: Mapping):
    H = np.asarray(p['spatial_coef']).reshape(-1).shape[0]
    V = np.asarray(p['proj_value']['kernel']).shape[1] // H
    Cz = np.asarray(p['proj_pair_bias']['kernel']).shape[0]
    P = np.asarray(p['proj_query_point']['kernel']).shape[1] // (3 * H)
    PV = np.asarray(p['proj_value_point']['kernel']).shape[1] // (3 * H)
    for name in ('proj_query', 'proj_key', 'proj_value', 'proj_pair_bias'):
        _linear(sd, f'{prefix}.{name}', p[name])
    for name, n in (('proj_query_point', P), ('proj_key_point', P),
                    ('proj_value_point', PV)):
        _linear(sd, f'{prefix}.{name}', p[name], cols=_interleave_perm(H, n))
    kern = np.asarray(p['out_transform']['kernel'], np.float32)
    perm = _interleave_perm(H, PV)
    o0 = H * Cz + H * V
    o1, o2 = o0 + 3 * H * PV, o0 + 4 * H * PV
    kern = np.concatenate([kern[:o0], kern[o0:o1][perm], kern[o1:o2],
                           kern[o2:][perm]], axis=0)
    _linear(sd, f'{prefix}.out_transform',
            {'kernel': kern, 'bias': p['out_transform']['bias']})
    sd[f'{prefix}.spatial_coef'] = _t(p['spatial_coef'])
    _layernorm(sd, f'{prefix}.layer_norm_1', p['LayerNorm_0'])
    _layernorm(sd, f'{prefix}.layer_norm_2', p['LayerNorm_1'])
    _mlp(sd, f'{prefix}.mlp_transition', p, (0, 2, 4))


def ga_block_state_dict(p: Mapping) -> Dict[str, torch.Tensor]:
    """One flax GABlock param subtree -> a GABlock state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _ga_block(sd, 'block', p)
    return {k[len('block.'):]: v for k, v in sd.items()}


def _residue_embed(sd: Dict, prefix: str, re: Mapping):
    sd[f'{prefix}.aatype_embed.weight'] = _t(re['Embed_0']['embedding'])
    sd[f'{prefix}.type_embed.weight'] = _t(re['Embed_1']['embedding'])
    _mlp(sd, f'{prefix}.mlp', re['MLP_0'], (0, 2, 4, 6))


def _pair_embed(sd: Dict, prefix: str, pe: Mapping):
    sd[f'{prefix}.aa_pair_embed.weight'] = _t(pe['Embed_0']['embedding'])
    sd[f'{prefix}.relpos_embed.weight'] = _t(pe['Embed_1']['embedding'])
    sd[f'{prefix}.aapair_to_distcoef.weight'] = _t(pe['Embed_2']['embedding'])
    _linear(sd, f'{prefix}.distance_embed.0', pe['Dense_0'])
    _linear(sd, f'{prefix}.distance_embed.2', pe['Dense_1'])
    _mlp(sd, f'{prefix}.out_mlp', pe['MLP_0'], (0, 2, 4))


def params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """DiffAbNet params (``{'params': {...}}`` or the inner dict) -> state
    dict for :class:`ab_opt_tpu_torch.models.diffab.DiffAbNet`."""
    p = params.get('params', params)
    sd: Dict[str, torch.Tensor] = {}
    ep = p['eps_net']
    _residue_embed(sd, 'residue_embed', p['residue_embed'])
    _pair_embed(sd, 'pair_embed', p['pair_embed'])

    pre = 'diffusion.eps_net'
    sd[f'{pre}.current_sequence_embedding.weight'] = _t(
        ep['seq_embed']['embedding'])
    _mlp(sd, f'{pre}.res_feat_mixer', ep['res_feat_mixer'], (0, 2))
    num_layers = sum(k.startswith('block_') for k in ep['encoder'])
    for i in range(num_layers):
        _ga_block(sd, f'{pre}.encoder.blocks.{i}', ep['encoder'][f'block_{i}'])
    for name in ('eps_crd_net', 'eps_rot_net', 'eps_seq_net'):
        _mlp(sd, f'{pre}.{name}', ep[name], (0, 2, 4))
    pr = ep['prmsd_predictor']
    _layernorm(sd, f'{pre}.prmsd_predictor.layer_norm', pr['LayerNorm_0'])
    for i in range(3):
        _linear(sd, f'{pre}.prmsd_predictor.linear_{i + 1}', pr[f'Dense_{i}'])
    return sd


# --------------------------------------------------------------------------- #
# The graph model (DiffGNNNet params -> DiffGNN state dict)
# --------------------------------------------------------------------------- #


def _geom_rows(C: int) -> np.ndarray:
    """``reference[perm[i]] = jax[i]`` over the 2 C^2 geometry rows: JAX
    lays them out [radial (C^2) | dist (C^2)], the reference per channel
    row [rad_c1 (C), dist_c1 (C), rad_c2, ...]."""
    perm = np.empty(2 * C * C, np.int64)
    for half in range(2):
        for c1 in range(C):
            for c2 in range(C):
                perm[half * C * C + c1 * C + c2] = c1 * 2 * C + half * C + c2
    return perm


def _kv_cols(F: int) -> np.ndarray:
    """The reference interleaves a fused projection's k and v columns (k =
    kv[:, 0::2]); JAX splits them in halves: reference column 2i is JAX's
    column i, 2i + 1 its F + i."""
    return np.stack([np.arange(F), F + np.arange(F)], axis=-1).reshape(-1)


def _linear_geom(sd: Dict, prefix: str, p: Mapping, sections, C: int,
                 kv: bool = False):
    """A Dense whose input rows hold a geometry section (``sections``: (width,
    is_geom) in order), put back in the reference's row order; with ``kv``
    its output columns interleaved back to the reference's k/v."""
    k = np.asarray(p['kernel'], np.float32)
    rows, off = [], 0
    for width, is_geom in sections:
        block = k[off:off + width]
        if is_geom:
            ref = np.empty_like(block)
            ref[_geom_rows(C)] = block
            block = ref
        rows.append(block)
        off += width
    _linear(sd, prefix, dict(p, kernel=np.concatenate(rows, axis=0)),
            cols=_kv_cols(k.shape[1] // 2) if kv else None)


def _mc_egcl(sd: Dict, prefix: str, p: Mapping, F: int, C: int, E: int):
    geo = 2 * C * C
    _linear_geom(sd, f'{prefix}.edge_mlp.0', p['Dense_0'],
                 [(F, False), (F, False), (geo, True), (E, False)], C)
    for i, name in enumerate(('edge_mlp.2', 'coord_mlp.0', 'coord_mlp.2',
                              'node_mlp.0', 'node_mlp.2')):
        _linear(sd, f'{prefix}.{name}', p[f'Dense_{i + 1}'])


def diff_gnn_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """DiffGNNNet params (``{'params': {...}}`` or the inner dict) -> state
    dict for :class:`ab_opt_tpu_torch.models.diff_gnn.DiffGNN`. The
    reference's per-layer ``time_mlp`` has no counterpart: its forward never
    runs it, and JAX drops it."""
    p = params.get('params', params)
    sd: Dict[str, torch.Tensor] = {}
    re = p['residue_embed']
    _residue_embed(sd, 'embed.residue_embed', re)
    if 'Embed_2' in re:
        sd['embed.residue_embed.hotspot_embed.weight'] = _t(
            re['Embed_2']['embedding'])
    _pair_embed(sd, 'embed.pair_embed', p['pair_embed'])

    g, sq = p['gnn'], p['seqgnn']
    F = np.asarray(g['linear_in']['kernel']).shape[1]
    C = np.asarray(g['out_layer']['Dense_3']['kernel']).shape[1]
    E = (np.asarray(g['out_layer']['Dense_0']['kernel']).shape[0]
         - 2 * F - 2 * C * C)
    _linear(sd, 'gnn.linear_in', g['linear_in'])
    n_layers = sum(k.startswith('gcl_') for k in g)
    for i in range(n_layers):
        _mc_egcl(sd, f'gnn.gcl_{i}', g[f'gcl_{i}'], F, C, E)
        a = g[f'att_{i}']
        _linear(sd, f'gnn.att_{i}.linear_q', a['linear_q'])
        _linear_geom(sd, f'gnn.att_{i}.linear_kv', a['linear_kv'],
                     [(2 * C * C, True), (F, False)], C, kv=True)
        _linear(sd, f'gnn.att_{i}.coord_mlp.0', a['Dense_0'])
        _linear(sd, f'gnn.att_{i}.coord_mlp.2', a['Dense_1'])
    _linear(sd, 'gnn.time_embedding', g['time_embedding'])
    _mc_egcl(sd, 'gnn.out_layer', g['out_layer'], F, C, E)
    _linear(sd, 'gnn.linear_out', g['linear_out'])

    _linear(sd, 'seqgnn.linear_q', sq['linear_q'])
    _linear_geom(sd, 'seqgnn.linear_kv', sq['linear_kv'],
                 [(2 * C * C, True), (F, False)], C, kv=True)
    sd['seqgnn.hydropathy_embed.weight'] = _t(sq['Embed_0']['embedding'])
    sd['seqgnn.charge_embed.weight'] = _t(sq['Embed_1']['embedding'])
    _mlp(sd, 'seqgnn.mlp', sq, (0, 2, 4))
    return sd
