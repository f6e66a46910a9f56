"""Design/docking CLI over :func:`~ab_opt_tpu_torch.runners.design.design_for_pdb`
(counterpart of ``ab_opt_tpu/runners/design_cli.py``, with ``--device``).

    python -m ab_opt_tpu_torch.runners.design_cli --pdb_path complex.pdb \\
        -c configs/test/codesign_single.yml -o results [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import logging

from ..utils.config import load_config
from .design import DesignArgs, design_for_pdb


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pdb_path', type=str, required=True)
    parser.add_argument('--id', type=str, default='')
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('-ck', '--ckpt', type=str, default=None)
    parser.add_argument('--heavy', type=str, default='H')
    parser.add_argument('--light', type=str, default='L')
    parser.add_argument('-n', '--num_samples', type=int, default=10)
    parser.add_argument('-b', '--batch_size', type=int, default=16)
    parser.add_argument('--topk', type=int, default=1)
    parser.add_argument('--no_renumber', action='store_true', default=False)
    parser.add_argument('--label_heavy_as_cdr', action='store_true', default=False)
    parser.add_argument('--contig', type=str, default='')
    parser.add_argument('-o', '--out_root', type=str, default='./results')
    parser.add_argument('-t', '--tag', type=str, default='')
    parser.add_argument('-s', '--seed', type=int, default=0)
    parser.add_argument('--no_dockq', action='store_true', default=False)
    parser.add_argument('--stride', type=int, default=1,
                        help='Strided (DDIM-style) sampling: >1 trades '
                             'quality for k-fold fewer denoiser steps.')
    parser.add_argument('--device', type=str, default=None,
                        help='Device to sample on (default: the CUDA card; '
                             '"cpu" runs on the CPU).')
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    config, _ = load_config(args.config)
    design_args = DesignArgs(
        pdb_path=args.pdb_path, ckpt=args.ckpt, config=dict(config),
        heavy=args.heavy, light=args.light, no_renumber=args.no_renumber,
        num_samples=args.num_samples, batch_size=args.batch_size,
        topk=args.topk, seed=args.seed, out_root=args.out_root, tag=args.tag,
        contig=args.contig, label_heavy_as_cdr=args.label_heavy_as_cdr,
        run_dockq=not args.no_dockq, id=args.id, stride=args.stride,
        device=args.device)
    results = design_for_pdb(design_args)
    print(results)
    return results


if __name__ == '__main__':
    main()
