"""Convert a reference (pengzhangzhi/ab_opt) torch checkpoint into a port
checkpoint (counterpart of ``scripts/convert_checkpoint.py``).

    python -m ab_opt_tpu_torch.runners.convert_checkpoint ref_250000.pt out.ckpt
        [--num_layers N]

The source is read without its config packages (``easydict``,
``dynamic_yaml``) and with no global but tensors, containers and config
classes (``train/checkpoint.py::read_reference_checkpoint``). Its state
dict goes through the converter of its config's model type (``diffab``
when the config names none; ``diff_gnn`` with its depth and widths from the
config), and the result is written with the config, the iteration and
``extra={'converted_from': SRC}``. The file then serves every entry point
that takes a port checkpoint (``design_cli --ckpt``, ``testset``,
``optimize``, ``design_dock``, ``train_cli --finetune``). The reference's
optimizer and scheduler states are not kept.
"""
from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional

from ..train.checkpoint import read_reference_checkpoint, save_checkpoint
from ..utils.torch_convert import (convert_diff_gnn_state_dict,
                                   convert_diffab_state_dict)

logger = logging.getLogger(__name__)


def convert(src: str, dst: str, num_layers: Optional[int] = None) -> Dict:
    """Write the port checkpoint of ``src`` to ``dst``; ``num_layers``
    overrides the config's depth. Returns the model type, depth, iteration
    and the names of the source's keys the port has no parameter for."""
    saved = read_reference_checkpoint(src)
    config = saved['config']
    model_cfg = config.get('model', {})
    model_type = model_cfg.get('type', 'diffab')
    if model_type == 'diffab':
        num_layers = num_layers or model_cfg.get('diffusion', {}).get(
            'eps_net_opt', {}).get('num_layers', 6)
        state_dict, dropped = convert_diffab_state_dict(
            saved['state_dict'], num_layers=num_layers)
    elif model_type == 'diff_gnn':
        from ..models.diff_gnn import DiffGNNConfig
        gnn = DiffGNNConfig.from_dict(model_cfg)
        num_layers = num_layers or gnn.n_layers
        state_dict, dropped = convert_diff_gnn_state_dict(
            saved['state_dict'], n_layers=num_layers, hidden=gnn.hidden_size,
            n_channel=gnn.num_atoms, edge_feat_dim=gnn.edge_feat_dim)
    else:
        raise ValueError(f'{src}: no converter for model type '
                         f'{model_type!r} (the port converts diffab and '
                         'diff_gnn)')
    save_checkpoint(dst, config=config, model=state_dict,
                    iteration=saved['iteration'],
                    extra={'converted_from': src})
    if dropped:
        logger.info('dropped %d keys the port has no parameter for: %s',
                    len(dropped), ', '.join(dropped))
    return {'type': model_type, 'num_layers': num_layers,
            'iteration': saved['iteration'], 'dropped': dropped}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('src', help='reference torch checkpoint (.pt)')
    parser.add_argument('dst', help='output port checkpoint (.ckpt)')
    parser.add_argument('--num_layers', type=int, default=None,
                        help='encoder depth (default: from the config)')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    info = convert(args.src, args.dst, args.num_layers)
    print(f'converted {args.src} -> {args.dst} ({info["num_layers"]}-layer '
          f'{info["type"]}, it {info["iteration"]}, '
          f'{len(info["dropped"])} keys dropped)')
    return info


if __name__ == '__main__':
    main()
