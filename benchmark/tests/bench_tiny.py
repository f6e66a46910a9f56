"""Tiny cells for the CPU tests: the configurations' structure at small
widths and depth, on the CPU, with limits that the tests set."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.manifest import Cell  # noqa: E402

DIFFAB = {'type': 'diffab', 'res_feat_dim': 16, 'pair_feat_dim': 8,
          'num_bins': 8, 'dist_min': 0.5, 'dist_max': 19.5,
          'diffusion': {'num_steps': 4, 'eps_net_opt': {'num_layers': 2},
                        'obj': 'pred_noise'},
          'train_structure': True, 'train_sequence': True,
          'dtype': 'float32', 'ipa_impl': 'auto'}
GNN = {'type': 'diff_gnn', 'res_feat_dim': 16, 'edge_feat_dim': 8,
       'hidden_size': 16, 'num_steps': 6, 'num_atoms': 3, 'n_layers': 2,
       'dropout': 0.1, 'hotspot': True, 'objective': 'pred_x0',
       'dtype': 'float32'}
TRAIN = {'batch_size': 4, 'max_grad_norm': 100.0,
         'optimizer': {'type': 'adam', 'lr': 1e-3, 'weight_decay': 0.0,
                       'beta1': 0.9, 'beta2': 0.999}}
SAMPLE_TRAFFIC = {'kind': 'sample', 'fan_out': 4, 'length': 32,
                  'antibody': 16, 'antigen': 12, 'cdr_start': 6,
                  'cdr_length': 5, 'pool': 2, 'trace_calls': 1,
                  'check_requests': 2, 'check_steps': 2}
TRAIN_TRAFFIC = {'kind': 'train', 'batch': 4, 'length': 32, 'antibody': 16,
                 'antigen': 12, 'cdr_start': 6, 'cdr_length': 5, 'pool': 3,
                 'label_drop': 0.3, 'trace_calls': 1}
SAMPLE_LIMITS = {'first_pos_gap_rms_A': 1e-3, 'first_rot_gap_median': 1e-3,
                 'step_eps_gap': 1e-3, 'seq_margin': 1e-3,
                 'context_changed': 0.0, 'backbone_gap_A': 1e-3}
_TRAIN = {'loss_gap': 1e-4, 'grad_gap': 1e-3, 'change_gap': 1e-3,
          'change_gap_median': 1e-3}
TRAIN_LIMITS = dict(_TRAIN, **{'window_' + n: v for n, v in _TRAIN.items()})


def cell(kind: str, model: str = 'diffab') -> Cell:
    """A tiny cell: ``kind`` 'sample' or 'train', ``model`` 'diffab' or
    'gnn'."""
    m = copy.deepcopy(DIFFAB if model == 'diffab' else GNN)
    w = {'rot': 1.0, 'pos': 1.0, 'seq': 1.0}
    if model == 'gnn':
        w['bb_pos'] = 1.0
    config = {'model': m, 'train': dict(copy.deepcopy(TRAIN),
                                        loss_weights=w)}
    if model == 'gnn':
        config['weight_scales'] = {'coord_mlp.2.weight': 0.0002}
    traffic = copy.deepcopy(SAMPLE_TRAFFIC if kind == 'sample'
                            else TRAIN_TRAFFIC)
    limits = dict(SAMPLE_LIMITS if kind == 'sample' else TRAIN_LIMITS)
    return Cell(name=f'tiny-{kind}-{model}', chips=1, config=config,
                traffic=traffic, limits=limits, end_to_end=[], per_layer=[])
