"""Global dock (HDock) and CDR design (counterpart of
``ab_opt_tpu/runners/design_dock.py``).

    python -m ab_opt_tpu_torch.runners.design_dock --antigen ag.pdb \\
        --antibody ab.pdb -c configs/test/codesign_single.yml [--device cpu]

HDock docks the antibody onto the antigen (CDR-H3 ligand-site
constrained); each docked pose then goes through the design runner, its
sampler on the card unless ``device`` names another. Needs the ``hdock``
and ``createpl`` binaries (:mod:`ab_opt_tpu_torch.tools.hdock`).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional

from ..tools.hdock import HDockAntibody
from ..utils.config import load_config
from ..utils.device import resolve_device
from .design import DesignArgs, design_for_pdb

logger = logging.getLogger(__name__)


def design_dock(antigen_pdb: str, antibody_pdb: str, config: Dict,
                ckpt: Optional[str] = None, out_root: str = './results/design_dock',
                num_docks: int = 10, num_samples: int = 8, batch_size: int = 8,
                heavy: str = 'H', light: str = 'L', seed: int = 0,
                device=None) -> List[Dict]:
    device = resolve_device(device)
    os.makedirs(out_root, exist_ok=True)
    docker = HDockAntibody()
    try:
        docker.set_antigen(antigen_pdb)
        docker.set_antibody(antibody_pdb, heavy_id=heavy)
        poses = docker.dock(num_poses=num_docks)
        results = []
        for i, pose in enumerate(poses):
            args = DesignArgs(
                pdb_path=pose, ckpt=ckpt, config=config, heavy=heavy,
                light=light, num_samples=num_samples, batch_size=batch_size,
                out_root=out_root, tag=f'dock{i:03d}', keep_traj=False,
                run_dockq=False, seed=seed, id=f'pose{i:03d}', device=device)
            results.append(design_for_pdb(args))
        return results
    finally:
        docker.cleanup()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--antigen', required=True)
    parser.add_argument('--antibody', required=True)
    parser.add_argument('-c', '--config', required=True)
    parser.add_argument('-ck', '--ckpt', default=None)
    parser.add_argument('-o', '--out_root', default='./results/design_dock')
    parser.add_argument('--num_docks', type=int, default=10)
    parser.add_argument('-n', '--num_samples', type=int, default=8)
    parser.add_argument('--heavy', default='H')
    parser.add_argument('--light', default='L')
    parser.add_argument('--device', type=str, default=None,
                        help='Device to sample on (default: the CUDA card; '
                             '"cpu" runs on the CPU).')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config, _ = load_config(args.config)
    return design_dock(args.antigen, args.antibody, dict(config),
                       ckpt=args.ckpt, out_root=args.out_root,
                       num_docks=args.num_docks, num_samples=args.num_samples,
                       heavy=args.heavy, light=args.light, device=args.device)


if __name__ == '__main__':
    main()
