"""The 3-stage antibody optimization pipeline (pose generation ->
sequence design -> screening); counterpart of
``ab_opt_tpu/runners/optimize.py``.

    python -m ab_opt_tpu_torch.runners.optimize --docked_pose_dir poses \\
        --seq_design_dir seq --screen_dir screen \\
        --design_config configs/test/seq_design.yml \\
        --dock_config configs/test/dock_cdr.yml [--device cpu]

  stage 0 (optional): relax the candidate poses
      (:mod:`ab_opt_tpu_torch.tools.relax`, when OpenMM and PyRosetta are
      installed); otherwise the poses are screened unrelaxed.
  stage 1: per pose, design CDR sequences with the seq-design model
      (``label_heavy_as_cdr`` and a contig sub-range).
  stage 2: re-dock every designed sequence with the docking model and rank
      the candidates by DockQ mean/std and pRMSD.

Each stage builds one model and reuses it for every pose; every sampler
call runs on the card unless ``device`` names another device.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import logging
import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..utils.config import load_config
from ..utils.device import resolve_device
from .design import (DesignArgs, design_for_pdb, load_model_from_checkpoint,
                     random_model)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class OptimizeArgs:
    docked_pose_dir: str             # stage-0 input: pose PDBs (NNNN.pdb)
    seq_design_dir: str              # stage-1 output dir
    screen_dir: str                  # stage-2 output dir
    design_ckpt: Optional[str] = None
    dock_ckpt: Optional[str] = None
    design_config: Optional[Dict] = None   # used when no ckpt (tests)
    dock_config: Optional[Dict] = None
    heavy_chain_id: str = 'H'
    design_contig: str = ''
    nums: int = 100                  # re-docking poses per designed seq
    num_designs: int = 8             # designed seqs per pose
    pdb_suffix: str = ''             # e.g. 'rosetta' to pick relaxed poses
    max_poses: Optional[int] = None
    relax: bool = False
    seed: int = 0
    batch_size: int = 16
    device: Optional[str] = None     # None -> the CUDA card


def scan_poses(pose_dir: str, suffix: str = '', max_poses: Optional[int] = None
               ) -> List[str]:
    """Find pose PDBs like 0000.pdb (optionally *_<suffix>.pdb)."""
    pat = re.compile(r'^\d+%s\.pdb$' % (f'_{suffix}' if suffix else ''))
    files = sorted(f for f in os.listdir(pose_dir) if pat.match(f))
    paths = [os.path.join(pose_dir, f) for f in files]
    return paths[:max_poses] if max_poses else paths


def _pipeline_model(ckpt: Optional[str], config: Optional[Dict], seed: int):
    """One model for a whole stage, which design_for_pdb then reuses for
    every pose: the checkpoint's, or random weights drawn from ``seed``."""
    if ckpt:
        return load_model_from_checkpoint(ckpt)[0]
    model_cfg = dict((config or {}).get('model', {}))
    model_cfg.setdefault('type', 'diffab')
    return random_model(model_cfg, seed)


def seq_design_batch(args: OptimizeArgs) -> List[str]:
    """Stage 1: design sequences for each pose."""
    poses = scan_poses(args.docked_pose_dir, args.pdb_suffix, args.max_poses)
    logger.info('Stage 1: designing sequences for %d poses', len(poses))
    os.makedirs(args.seq_design_dir, exist_ok=True)
    model = _pipeline_model(args.design_ckpt, args.design_config, args.seed)
    out_dirs = []
    for pose_path in poses:
        name = os.path.splitext(os.path.basename(pose_path))[0]
        d_args = DesignArgs(
            pdb_path=pose_path, ckpt=args.design_ckpt,
            config=args.design_config, heavy=args.heavy_chain_id, light=None,
            num_samples=args.num_designs, batch_size=args.batch_size,
            label_heavy_as_cdr=True, contig=args.design_contig,
            out_root=args.seq_design_dir, tag=name, keep_traj=False,
            run_dockq=False, seed=args.seed, id=name, device=args.device)
        design_for_pdb(d_args, model=model)
        out_dirs.append(os.path.join(args.seq_design_dir, f'{name}_{name}'))
    return out_dirs


def dock_seqs(args: OptimizeArgs, design_dirs: List[str]) -> Dict[str, Dict]:
    """Stage 2: re-dock designed sequences, score DockQ/pRMSD."""
    os.makedirs(args.screen_dir, exist_ok=True)
    results = {}
    sample_paths = []
    for d in design_dirs:
        sample_paths.extend(sorted(glob.glob(os.path.join(d, '*', '[0-9]*.pdb'))))
    logger.info('Stage 2: re-docking %d designed sequences', len(sample_paths))

    model = _pipeline_model(args.dock_ckpt, args.dock_config, args.seed)
    for path in sample_paths:
        name = os.path.relpath(path, args.seq_design_dir).replace(os.sep, '__')[:-4]
        d_args = DesignArgs(
            pdb_path=path, ckpt=args.dock_ckpt, config=args.dock_config,
            heavy=args.heavy_chain_id, light=None,
            num_samples=args.nums, batch_size=args.batch_size,
            label_heavy_as_cdr=True, out_root=args.screen_dir, tag=name,
            keep_traj=False, run_dockq=True, seed=args.seed, id=name,
            device=args.device)
        res = design_for_pdb(d_args, model=model)
        for tag, summ in res.items():
            results[f'{name}/{tag}'] = summ
    return results


def summarize_screening(results: Dict[str, Dict], screen_dir: str,
                        prmsd_quantile: float = 0.5):
    """Rank and filter candidates: high DockQ mean, low DockQ/pRMSD std
    (stable poses), confident pRMSD. ``selected`` is the median-quantile
    filter: DockQ_std <= median AND prmsd_std <= median AND prmsd_avg <=
    median."""
    import pandas as pd
    rows = []
    for name, summ in results.items():
        rows.append({
            'candidate': name,
            'DockQ_avg': summ.get('DockQ_mean', float('nan')),
            'DockQ_std': summ.get('DockQ_std', float('nan')),
            'prmsd_avg': summ.get('prmsd_mean', float('nan')),
            'prmsd_std': summ.get('prmsd_std', float('nan')),
            'AAR': summ.get('AAR_mean', float('nan')),
        })
    df = pd.DataFrame(rows)
    if len(df):
        cut = df['prmsd_avg'].quantile(prmsd_quantile)
        df['confident'] = df['prmsd_avg'] <= cut
        med = df[['DockQ_std', 'prmsd_std', 'prmsd_avg']].quantile(0.5)
        df['selected'] = ((df['DockQ_std'] <= med['DockQ_std'])
                          & (df['prmsd_std'] <= med['prmsd_std'])
                          & (df['prmsd_avg'] <= med['prmsd_avg']))
        df = df.sort_values(['confident', 'DockQ_avg'],
                            ascending=[False, False])
    df.to_csv(os.path.join(screen_dir, 'screening_summary.csv'), index=False)
    return df


def optimize_antibody(args: OptimizeArgs):
    """Full pipeline entry (optionally with stage-0 relax). ``args.device``
    None samples on the CUDA card and raises without one."""
    resolve_device(args.device)
    if args.relax:
        from ..tools.relax import relax_directory
        relax_directory(args.docked_pose_dir)
        if not args.pdb_suffix:
            args = dataclasses.replace(args, pdb_suffix='rosetta')

    design_dirs = seq_design_batch(args)
    results = dock_seqs(args, design_dirs)
    return summarize_screening(results, args.screen_dir)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--docked_pose_dir', required=True)
    parser.add_argument('--seq_design_dir', required=True)
    parser.add_argument('--screen_dir', required=True)
    parser.add_argument('--design_model_ckpt', default=None)
    parser.add_argument('--dock_model_ckpt', default=None)
    parser.add_argument('--design_config', default=None)
    parser.add_argument('--dock_config', default=None)
    parser.add_argument('--design_contig', default='')
    parser.add_argument('--heavy_chain_id', default='H')
    parser.add_argument('--nums', type=int, default=100)
    parser.add_argument('--num_designs', type=int, default=8)
    parser.add_argument('--pdb_suffix', default='')
    parser.add_argument('--max_poses', type=int, default=None)
    parser.add_argument('--relax', action='store_true', default=False)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default=None,
                        help='Device to sample on (default: the CUDA card; '
                             '"cpu" runs on the CPU).')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    design_cfg = dict(load_config(args.design_config)[0]) if args.design_config else None
    dock_cfg = dict(load_config(args.dock_config)[0]) if args.dock_config else None
    return optimize_antibody(OptimizeArgs(
        docked_pose_dir=args.docked_pose_dir,
        seq_design_dir=args.seq_design_dir, screen_dir=args.screen_dir,
        design_ckpt=args.design_model_ckpt, dock_ckpt=args.dock_model_ckpt,
        design_config=design_cfg, dock_config=dock_cfg,
        heavy_chain_id=args.heavy_chain_id, design_contig=args.design_contig,
        nums=args.nums, num_designs=args.num_designs,
        pdb_suffix=args.pdb_suffix, max_poses=args.max_poses,
        relax=args.relax, seed=args.seed, device=args.device))


if __name__ == '__main__':
    main()
