"""The test-set runner: design over a dataset split, then aggregate the
per-complex results (counterpart of ``ab_opt_tpu/runners/testset.py``).

    python -m ab_opt_tpu_torch.runners.testset -c configs/test/codesign_single.yml \\
        -o results/testset [-n 10] [--relax [--energy]] [--device cpu]

Each complex of the config's ``dataset.test`` split goes through
:func:`~ab_opt_tpu_torch.runners.design.design_for_structure` (the sampler
on the card unless ``device`` names another); the per-complex results.csv
summaries are gathered into testset_results.csv and testset_summary.csv.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, Optional

import numpy as np

from ..data import get_dataset
from ..utils.config import load_config
from ..utils.device import resolve_device
from .design import (DesignArgs, design_for_structure,
                     load_model_from_checkpoint, random_model)

logger = logging.getLogger(__name__)


def design_for_testset(config: Dict, ckpt: Optional[str] = None,
                       out_root: str = './results/testset',
                       num_samples: int = 10, batch_size: int = 16,
                       topk: int = 1, seed: int = 0,
                       limit: Optional[int] = None,
                       run_dockq: bool = True,
                       relax: bool = False,
                       with_energy: bool = False,
                       device=None) -> Dict:
    """Run the per-structure design pipeline over the configured test split.

    ``relax``: after each complex, run the OpenMM+PyRosetta relaxation
    pipeline over its sample PDBs and score similarity (and interface
    energy with ``with_energy``). Both backends are optional plug-ins; a
    missing backend logs a warning and the scan continues. ``device=None``
    samples on the CUDA card and raises without one.
    """
    device = resolve_device(device)
    dataset_cfg = dict(config['dataset']['test'])
    dataset_cfg.pop('transform', None)
    dataset = get_dataset(dataset_cfg)
    logger.info('Test split: %d structures', len(dataset))

    if ckpt:
        model, _ = load_model_from_checkpoint(ckpt)
    else:
        model = random_model(dict(config.get('model', {}), type='diffab'),
                             seed)

    all_results = {}
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        structure = dataset.get_structure(dataset.ids_in_split[i])
        sid = structure['id']
        log_dir = os.path.join(out_root, sid)
        os.makedirs(log_dir, exist_ok=True)
        args = DesignArgs(pdb_path='', num_samples=num_samples,
                          batch_size=batch_size, topk=topk, seed=seed,
                          out_root=out_root, keep_traj=False,
                          run_dockq=run_dockq, device=device)
        try:
            res = design_for_structure(structure, model, dict(config), args,
                                       log_dir)
        except Exception as e:   # keep scanning; record the failure
            logger.exception('[%s] failed: %s', sid, e)
            continue
        all_results[sid] = res
        if relax:
            _relax_and_score(log_dir, with_energy)

    summary = aggregate_results(all_results, out_root)
    return summary


def _relax_and_score(log_dir: str, with_energy: bool) -> None:
    """Relax and score one complex's samples in place (optional plug-ins)."""
    from ..tools.eval import evaluate_directory
    from ..tools.relax import relax_directory
    try:
        relax_directory(log_dir, pipeline='openmm_pyrosetta')
    except RuntimeError as e:                 # backend not installed
        logger.warning('[relax] skipped for %s: %s', log_dir, e)
        return
    try:
        evaluate_directory(log_dir, postfix='rosetta',
                           with_energy=with_energy)
    except Exception as e:
        logger.warning('[eval] failed for %s: %s', log_dir, e)


def aggregate_results(all_results: Dict, out_root: str) -> Dict:
    """Mean of per-variant metric means across complexes ->
    testset_results.csv.

    ``testset_summary.csv`` carries the global means plus per-CDR columns
    (``<metric>/<tag>``, e.g. ``DockQ_mean/H_CDR3``)."""
    import pandas as pd
    rows = []
    for sid, variants in all_results.items():
        for tag, summ in variants.items():
            row = {'id': sid, 'tag': tag}
            row.update({k: v for k, v in summ.items()
                        if isinstance(v, (int, float))})
            rows.append(row)
    df = pd.DataFrame(rows)
    os.makedirs(out_root, exist_ok=True)
    df.to_csv(os.path.join(out_root, 'testset_results.csv'), index=False)
    if len(df) == 0:
        return {}
    means = df.select_dtypes(include=[np.number]).mean().to_dict()
    summary = {k: round(float(v), 4) for k, v in means.items()}
    for tag, group in df.groupby('tag'):
        for k, v in group.select_dtypes(include=[np.number]).mean().items():
            summary[f'{k}/{tag}'] = round(float(v), 4)
    pd.DataFrame([summary]).to_csv(
        os.path.join(out_root, 'testset_summary.csv'), index=False)
    logger.info('Testset summary: %s', summary)
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-c', '--config', type=str, required=True)
    parser.add_argument('-ck', '--ckpt', type=str, default=None)
    parser.add_argument('-o', '--out_root', type=str, default='./results/testset')
    parser.add_argument('-n', '--num_samples', type=int, default=10)
    parser.add_argument('-b', '--batch_size', type=int, default=16)
    parser.add_argument('--topk', type=int, default=1)
    parser.add_argument('--limit', type=int, default=None)
    parser.add_argument('-s', '--seed', type=int, default=0)
    parser.add_argument('--relax', action='store_true',
                        help='OpenMM+PyRosetta relax + similarity scoring '
                             'per complex (optional plug-ins)')
    parser.add_argument('--energy', action='store_true',
                        help='with --relax: also score interface energy')
    parser.add_argument('--device', type=str, default=None,
                        help='Device to sample on (default: the CUDA card; '
                             '"cpu" runs on the CPU).')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config, _ = load_config(args.config)
    return design_for_testset(
        dict(config), ckpt=args.ckpt, out_root=args.out_root,
        num_samples=args.num_samples, batch_size=args.batch_size,
        topk=args.topk, seed=args.seed, limit=args.limit,
        relax=args.relax, with_energy=args.energy, device=args.device)


if __name__ == '__main__':
    main()
