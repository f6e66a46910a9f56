"""The graph model (``diff_gnn``) through the port's entry points, on the
CPU:

* ``python -m ab_opt_tpu_torch.runners.train_cli --device cpu`` on
  ``configs/train/aa_label.yml`` cut to tiny widths (1 layer, 4 steps, crop
  16 + 16, batch 4, 3 steps, validation and a sampling eval at step 3) over
  a mini-SAbDab (``write_mini_sabdab``): it trains the port's ``DiffGNN``
  and writes a ``diff_gnn`` checkpoint that ``load_model_from_checkpoint``
  reloads with the same weights (the port's counterpart of the JAX
  package's ``tests/test_e2e_train_gnn.py``, which needs a reference
  checkout);
* a checkpoint that the JAX package's ``save_checkpoint`` wrote for its
  ``DiffGNN`` goes through ``read_weights``'s ``diff_gnn`` bridge;
* ``design_for_pdb`` with a tiny GNN config, both packages' samplers
  patched to the same fixed arrays: the same files as JAX's (the hotspot
  crop and the property labels of the GNN branch), in co-design and abopt
  modes;
* ``BatchedSampler`` on a tiny GNN on the CPU, with fan-out, ``opt_step``
  and ``stride``: finite outputs, the context unchanged, one seed one
  result.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch.models import DiffGNN  # noqa: E402
from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_mini_sabdab, write_synthetic_complex)
from test_torch_design import (_assert_traj_close, _fixed_out,  # noqa: E402
                               _tree)
from test_torch_gnn import gnn_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_GNN = dict(res_feat_dim=16, edge_feat_dim=8, hidden_size=16, n_layers=1,
                num_steps=4)
ITERS = 3


@pytest.fixture(scope='module')
def tiny_yml(tmp_path_factory):
    """aa_label.yml over a mini-SAbDab, the model and the crop cut down."""
    root = tmp_path_factory.mktemp('gnn_cli')
    paths = write_mini_sabdab(str(root), n=28)
    cfg = yaml.safe_load(open(os.path.join(REPO, 'configs', 'train',
                                           'aa_label.yml')))
    cfg['model'].update(TINY_GNN)
    cfg['train'].update(max_iters=ITERS, val_freq=ITERS, batch_size=4,
                        sampling_eval={'enabled': True, 'num_items': 2,
                                       'num_samples': 2})
    for split in ('train', 'val'):
        cfg['dataset'][split].update(paths)
        for tfm in cfg['dataset'][split]['transform']:
            if tfm['type'] == 'patch_around_anchor_hotspot':
                tfm.update(initial_patch_size=16, antigen_size=16)
    yml = str(root / 'aa_label_tiny.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(cfg, f)
    return yml


def test_train_cli_writes_a_gnn_checkpoint(tiny_yml, tmp_path):
    from ab_opt_tpu_torch.runners import train_cli
    trainer = train_cli.main(['--config', tiny_yml, '--logdir',
                              str(tmp_path), '--device', 'cpu'])
    assert isinstance(trainer.model, DiffGNN)
    assert trainer.iteration == ITERS and trainer.device.type == 'cpu'
    log_dir = trainer.log_dir
    ckpt = os.path.join(log_dir, 'checkpoints', f'{ITERS}.ckpt')
    best = [f for f in os.listdir(os.path.join(log_dir, 'checkpoints'))
            if f.startswith('best_rmsd_')]
    assert len(best) == 1
    assert os.path.exists(os.path.join(log_dir, 'sampling_eval', f'it{ITERS}',
                                       'results.csv'))
    model, cfg = TD.load_model_from_checkpoint(ckpt)
    assert isinstance(model, DiffGNN) and cfg['model']['type'] == 'diff_gnn'
    assert model.cfg.hotspot and model.cfg.n_layers == 1
    want = trainer.model.state_dict()
    assert sorted(model.state_dict()) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(model.state_dict()[k], v.cpu(), rtol=0,
                                   atol=0, msg=k)


def test_jax_gnn_checkpoint_reads(tmp_path):
    import optax
    from ab_opt_tpu.models import DiffGNN as JDiffGNN
    from ab_opt_tpu.train.checkpoint import save_checkpoint
    from ab_opt_tpu.utils.config import ConfigDict
    from ab_opt_tpu_torch.train.checkpoint import read_weights
    from ab_opt_tpu_torch.utils.convert import diff_gnn_params_to_state_dict
    model_cfg = dict(TINY_GNN, type='diff_gnn')
    jm = JDiffGNN(dict(model_cfg))
    params = jax.jit(jm.init)(jax.random.key(0), gnn_batch())
    ckpt = str(tmp_path / 'jax_gnn.ckpt')
    save_checkpoint(ckpt, config=ConfigDict.wrap({'model': model_cfg}),
                    params=params, opt_state=optax.adam(1e-4).init(params),
                    iteration=2)
    got = read_weights(ckpt)
    want = diff_gnn_params_to_state_dict(params)
    assert sorted(got['state_dict']) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got['state_dict'][k], v, rtol=0, atol=0,
                                   msg=k)
    model, cfg = TD.load_model_from_checkpoint(ckpt)
    assert isinstance(model, DiffGNN) and cfg['model'] == model_cfg


def _gnn_fixed_out(batch_np, n, keep_traj):
    """The fixed sampler output of tests/test_torch_design.py without the
    confidence outputs the graph model has no head for."""
    out = _fixed_out(batch_np, n, keep_traj)
    del out['prmsd'], out['perplexity']
    return out


GNN_CFG = {'mode': 'single_cdr',
           'sampling': {'cdrs': ['H_CDR3'], 'sample_structure': True,
                        'sample_sequence': True},
           'model': dict(TINY_GNN, type='diff_gnn', initial_patch_size=32,
                         antigen_size=32)}


@pytest.mark.parametrize('mode', ['single_cdr', 'abopt'])
def test_design_for_pdb_gnn_writes_what_jax_writes(tmp_path, monkeypatch,
                                                   mode):
    from ab_opt_tpu.models import DiffGNN as JDiffGNN
    from ab_opt_tpu.runners import design as JD
    monkeypatch.setattr(
        JD.BatchedSampler, '__call__',
        lambda self, b, key, num_replicas=1: _gnn_fixed_out(
            b, num_replicas, self.keep_traj))
    monkeypatch.setattr(
        TD.BatchedSampler, '__call__',
        lambda self, b, seed, num_replicas=1: _gnn_fixed_out(
            b, num_replicas, self.keep_traj))
    cfg = dict(GNN_CFG, mode=mode)
    if mode == 'abopt':
        cfg['sampling'] = dict(cfg['sampling'], optimize_steps=[2])
    pdb = write_synthetic_complex(str(tmp_path / 'cx.pdb'), seed=3)
    kw = dict(pdb_path=pdb, config=cfg, num_samples=3, batch_size=2, topk=2,
              keep_traj=True, run_dockq=True, seed=4)
    got = TD.design_for_pdb(TD.DesignArgs(out_root=str(tmp_path / 'port'),
                                          device='cpu', **kw))
    want = JD.design_for_pdb(JD.DesignArgs(out_root=str(tmp_path / 'jax'),
                                           **kw),
                             JDiffGNN(dict(cfg['model'])), {})
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    tp, tj = _tree(tmp_path / 'port'), _tree(tmp_path / 'jax')
    assert sorted(tp) == sorted(tj)
    for k in tp:
        if k.endswith('traj.pdb'):
            _assert_traj_close(tp[k], tj[k])
        else:
            assert tp[k] == tj[k], k


@pytest.mark.parametrize('flags', [dict(), dict(opt_step=3),
                                   dict(stride=2, keep_traj=True)])
def test_batched_sampler_runs_a_gnn(flags):
    model = TD.random_model(dict(TINY_GNN, type='diff_gnn'), seed=1)
    batch = {k: v[:1] for k, v in gnn_batch(seed=2).items()}
    sampler = TD.BatchedSampler(model, device='cpu', **flags)
    out = sampler(batch, seed=5, num_replicas=3)
    again = sampler(batch, seed=5, num_replicas=3)
    assert out['s'].shape == (3, 24) and out['pos_atom_new'].shape[:2] == (
        3, 24)
    for k in ('v', 'p', 'pos_atom_new'):
        assert np.isfinite(out[k]).all(), k
        np.testing.assert_array_equal(out[k], again[k])
    gen = batch['generate_flag'][0]
    np.testing.assert_array_equal(out['s'][:, ~gen],
                                  np.repeat(batch['aa'][:, ~gen], 3, 0))
    np.testing.assert_allclose(
        out['pos_atom_new'][:, ~gen][:, :, :4],
        np.repeat(batch['pos_heavyatom'][:, ~gen][:, :, :4], 3, 0),
        atol=1e-5)
    assert np.abs(out['p'][:, gen] - batch['pos_heavyatom'][:, gen, 1]
                  ).max() > 0.1
    if flags.get('keep_traj'):
        assert out['traj']['p'].shape[:2] == (2, 3)
