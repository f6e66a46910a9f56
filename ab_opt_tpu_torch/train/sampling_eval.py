"""Sampling-in-the-loop validation (counterpart of
``ab_opt_tpu/train/sampling_eval.py``): every val period, design the val
structures with :meth:`DiffAb.sample` and log per-CDR CA-RMSD and AAR;
checkpoints are ranked by CDR-H3 RMSD.

On the card the sampler's encoder runs through K1 (or K5, or K4 past 256
residues: :func:`~ab_opt_tpu_torch.models.diffab.encoder_route`). The host
side (collation, metrics, the sample PDBs and ``results.csv``) is the same
numpy code as the JAX package's.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.collate import PaddingCollate, to_device_batch
from ..metrics import amino_acid_recovery, ca_rmsd

logger = logging.getLogger(__name__)


_CDR_TAGS = {1: 'H_CDR1', 2: 'H_CDR2', 3: 'H_CDR3',
             4: 'L_CDR1', 5: 'L_CDR2', 6: 'L_CDR3'}


def _cdr_tag(cdr_flag: np.ndarray, gen: np.ndarray) -> str:
    """Name of the (single) CDR being generated, or 'region'."""
    vals, counts = np.unique(cdr_flag[gen], return_counts=True)
    vals = vals[vals > 0]
    if len(vals) == 0:
        return 'region'
    return _CDR_TAGS.get(int(vals[np.argmax(counts[-len(vals):])]), 'region')


@torch.no_grad()
def evaluate_samples(model, items: List[Dict], seed: int,
                     num_samples: int = 1, batch_size: int = 8,
                     out_dir: Optional[str] = None,
                     device=None) -> Dict[str, float]:
    """Sample each val item and compute CA-RMSD + AAR on the generate region.

    ``items`` are transformed (merged/cropped) structure dicts; each chunk
    of ``batch_size`` items is collated ``num_samples`` times over and
    sampled in one :meth:`DiffAb.sample` call on ``device`` (the model's
    device when None), every call drawing from one generator seeded with
    ``seed``. Returns global means plus a per-CDR breakdown
    (``rmsd/H_CDR3`` etc.). With ``out_dir``, each sampled crop is dumped
    as a PDB and a per-sample ``results.csv`` is written.
    """
    collate = PaddingCollate()
    device = device or next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    per_tag: Dict[str, Dict[str, list]] = {}
    rows = []
    for lo in range(0, len(items), batch_size):
        chunk = items[lo:lo + batch_size]
        reps = num_samples if num_samples > 1 else 1
        batch_np = collate(chunk * reps)
        out = model.sample(to_device_batch(batch_np, device),
                           generator=generator)
        out = {k: out[k].cpu().numpy() for k in ('v', 'p', 's')}
        p, s = out['p'], out['s']
        gen = (np.asarray(batch_np['generate_flag'])
               & np.asarray(batch_np['mask']))
        cdr_flag = np.asarray(batch_np.get('cdr_flag',
                                           np.zeros(gen.shape, np.int32)))
        native_ca = np.asarray(batch_np['pos_heavyatom'][:, :, 1])
        native_aa = np.asarray(batch_np['aa'])
        for i in range(p.shape[0]):
            g = gen[i]
            if g.sum() == 0:
                continue
            tag = _cdr_tag(cdr_flag[i], g)
            rmsd = ca_rmsd(p[i][g], native_ca[i][g])
            aar = amino_acid_recovery(s[i][g], native_aa[i][g])
            acc = per_tag.setdefault(tag, {'rmsd': [], 'aar': []})
            acc['rmsd'].append(rmsd)
            acc['aar'].append(aar)
            rows.append({'item': lo + i, 'tag': tag,
                         'rmsd': round(float(rmsd), 4),
                         'aar': round(float(aar), 4)})
            if out_dir is not None:
                _dump_sample(out_dir, f'{lo + i:04d}_{tag}', batch_np, out, i)

    rmsds = [r for acc in per_tag.values() for r in acc['rmsd']]
    aars = [a for acc in per_tag.values() for a in acc['aar']]
    result = {
        'rmsd': float(np.mean(rmsds)) if rmsds else float('nan'),
        'aar': float(np.mean(aars)) if aars else float('nan'),
        'n': len(rmsds),
    }
    for tag, acc in sorted(per_tag.items()):
        result[f'rmsd/{tag}'] = float(np.mean(acc['rmsd']))
        result[f'aar/{tag}'] = float(np.mean(acc['aar']))
    if out_dir is not None and rows:
        import pandas as pd
        os.makedirs(out_dir, exist_ok=True)
        pd.DataFrame(rows).to_csv(os.path.join(out_dir, 'results.csv'),
                                  index=False)
    return result


def _dump_sample(out_dir: str, name: str, batch_np, out, i: int) -> None:
    """Write one sampled crop as a PDB (backbone rebuilt from v/p/s)."""
    from ..data.pdb import save_pdb
    from ..geometry import reconstruct_backbone_partially, so3vec_to_rotation

    os.makedirs(out_dir, exist_ok=True)
    sl = slice(i, i + 1)
    tt = lambda a: torch.from_numpy(np.asarray(a[sl]))
    pos_new, mask_new = reconstruct_backbone_partially(
        tt(batch_np['pos_heavyatom']), so3vec_to_rotation(tt(out['v'])),
        tt(out['p']), tt(out['s']), tt(batch_np['chain_nb']),
        tt(batch_np['res_nb']), tt(batch_np['mask_heavyatom']),
        tt(batch_np['generate_flag']))
    L = np.asarray(batch_np['aa'][i]).shape[0]
    data = {
        'chain_nb': batch_np['chain_nb'][i],
        'chain_id': batch_np.get('chain_id', [['A'] * L] * (i + 1))[i],
        'resseq': batch_np.get('resseq', [np.arange(1, L + 1)] * (i + 1))[i],
        'icode': batch_np.get('icode', [[' '] * L] * (i + 1))[i],
        'aa': np.asarray(out['s'][i]),
        'pos_heavyatom': pos_new[0].numpy(),
        'mask_heavyatom': mask_new[0].numpy(),
    }
    try:
        save_pdb(data, os.path.join(out_dir, f'{name}.pdb'))
    except (KeyError, IndexError, ValueError) as e:
        logger.warning('sample dump failed for %s: %s', name, e)


class BestCheckpointTracker:
    """Keep the best checkpoint by val RMSD."""

    def __init__(self, ckpt_dir: str, metric: str = 'rmsd', minimize: bool = True):
        self.ckpt_dir = ckpt_dir
        self.metric = metric
        self.minimize = minimize
        self.best: Optional[float] = None
        self.best_path: Optional[str] = None

    def update(self, value: float, save_fn, iteration: int) -> bool:
        better = (self.best is None
                  or (value < self.best if self.minimize else value > self.best))
        if better and np.isfinite(value):
            self.best = value
            path = os.path.join(
                self.ckpt_dir, f'best_{self.metric}_{value:.3f}_it{iteration}.ckpt')
            save_fn(path)
            if self.best_path and os.path.exists(self.best_path):
                os.unlink(self.best_path)
            self.best_path = path
            logger.info('New best %s=%.4f at it %d', self.metric, value, iteration)
        return better
