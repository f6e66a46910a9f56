"""Reference (pengzhangzhi/ab_opt) torch state dicts -> the port's (the
port's own counterpart of ``ab_opt_tpu/utils/torch_convert.py``).

The port keeps the reference's parameter names and layouts for both
models: DiffAb's GABlock point projections stay in the interleaved (head,
point, xyz) column order, the graph model's edge geometry in its
per-channel-row order and its fused k/v projections interleaved. So a
reference state dict needs no re-layout. Each function builds the port
model of the given depth (its widths read from the state dict), takes
every key of that model from the state dict, checks its shape and casts
it to a float32 CPU tensor. The keys the port has no parameter for (the
reference's buffers, the graph model's unused per-layer ``time_mlp``) are
dropped, as the JAX converter drops them, and returned by name.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to('cpu', torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _width(sd: Mapping, key: str, axis: int, default: int) -> int:
    return int(np.shape(sd[key])[axis]) if key in sd else default


def _select(sd: Mapping, model: torch.nn.Module,
            what: str) -> Tuple[StateDict, List[str]]:
    """Every key of ``model`` taken from ``sd`` with its shape checked;
    raises a ValueError naming each missing or mis-shaped key."""
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    shapes = [f'{k} {tuple(np.shape(sd[k]))} (the port: {tuple(v.shape)})'
              for k, v in want.items()
              if k in sd and tuple(np.shape(sd[k])) != tuple(v.shape)]
    if missing or shapes:
        raise ValueError(
            f'the state dict does not fit the port\'s {what}: '
            + '; '.join(([f'missing {", ".join(missing)}'] if missing else [])
                        + ([f'wrong shape {"; ".join(shapes)}']
                           if shapes else [])))
    return ({k: _tensor(sd[k]) for k in want},
            sorted(k for k in sd if k not in want))


def _built(cls, cfg):
    """The port model of ``cfg``, its random initialisation drawn without
    touching the global generator."""
    with torch.random.fork_rng(devices=[]):
        return cls(cfg)


def convert_diffab_state_dict(sd: Mapping, num_layers: int = 6
                              ) -> Tuple[StateDict, List[str]]:
    """A ``DiffusionAntibodyDesign`` state dict -> (state dict of the
    port's ``DiffAb``, the names of the keys dropped). The widths (residue
    and pair features, atoms, pRMSD bins) are read from the embeddings and
    the pRMSD head; the depth is ``num_layers``."""
    from ..models.diffab import DiffAbConfig, DiffAbNet
    d = DiffAbConfig()
    cfg = DiffAbConfig(
        res_feat_dim=_width(sd, 'residue_embed.aatype_embed.weight', 1,
                            d.res_feat_dim),
        pair_feat_dim=_width(sd, 'pair_embed.aa_pair_embed.weight', 1,
                             d.pair_feat_dim),
        num_atoms=math.isqrt(_width(
            sd, 'pair_embed.aapair_to_distcoef.weight', 1, d.num_atoms ** 2)),
        num_bins=_width(sd, 'diffusion.eps_net.prmsd_predictor.linear_3.weight',
                        0, d.num_bins),
        num_layers=num_layers)
    return _select(sd, _built(DiffAbNet, cfg), f'{num_layers}-layer diffab')


def convert_diff_gnn_state_dict(sd: Mapping, n_layers: int = 6,
                                hidden: int = 128, n_channel: int = 3,
                                edge_feat_dim: int = 128
                                ) -> Tuple[StateDict, List[str]]:
    """An AbDesign ``DiffusionGNN`` state dict -> (state dict of the port's
    ``DiffGNN``, the names of the keys dropped). The hotspot embedding is
    optional, as in the JAX converter; the residue features' width and
    whether the output layer reads every layer's hidden state (``dense``)
    are read from the state dict."""
    from ..models.diff_gnn import DiffGNN, DiffGNNConfig
    cfg = DiffGNNConfig(
        res_feat_dim=_width(sd, 'embed.residue_embed.aatype_embed.weight', 1,
                            DiffGNNConfig.res_feat_dim),
        edge_feat_dim=edge_feat_dim, hidden_size=hidden,
        num_atoms=n_channel, n_layers=n_layers,
        hotspot='embed.residue_embed.hotspot_embed.weight' in sd,
        dense=_width(sd, 'gnn.linear_out.weight', 1, hidden) != hidden)
    return _select(sd, _built(DiffGNN, cfg), f'{n_layers}-layer diff_gnn')
