"""The port's design runner (``runners/design.py``, ``runners/design_cli.py``)
against the JAX package's, on a synthetic Chothia complex the test writes
(heavy H, light L, antigen A):

* both packages' ``BatchedSampler.__call__`` patched to return the same
  fixed arrays: the port's ``design_for_pdb`` writes the same files as
  JAX's (metadata.json, REF1.pdb, every sample PDB, results.csv and aa.csv
  byte for byte; traj.pdb, rebuilt by each package's own geometry, within
  2e-3 A per coordinate) in co-design, docking and abopt modes, with the
  samples split over several sampler calls;
* a JAX checkpoint (a pickle with the JAX package's ConfigDict and an optax
  state) loads, and drives the CLI, in a process where jax, flax, optax and
  the JAX package cannot be imported; a port checkpoint loads as it is;
* ``python -m ab_opt_tpu_torch.runners.design_cli --device cpu`` with a tiny
  config writes the file tree of tests/test_runner.py through the real
  sampler (the kernels' plain versions), renumbering through the
  passthrough check; two runs of one seed write the same files;
* the registry (both models, and its refusal of an unregistered type),
  the chunk seeds and the device default.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_synthetic_complex)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MODEL = {'res_feat_dim': 16, 'pair_feat_dim': 8, 'num_bins': 8,
              'initial_patch_size': 0, 'antigen_size': 20,
              'remove_anchor': True,
              'diffusion': {'num_steps': 4, 'eps_net_opt': {'num_layers': 1},
                            'obj': 'pred_x0'}}
TINY_CFG = {'mode': 'single_cdr',
            'sampling': {'cdrs': ['H_CDR3'], 'sample_structure': True,
                         'sample_sequence': True},
            'model': TINY_MODEL}
CONFIGS = {
    'codesign': dict(TINY_CFG, sampling={
        'cdrs': ['H_CDR3', 'L_CDR3'], 'sample_structure': True,
        'sample_sequence': True},
        model=dict(TINY_MODEL, initial_patch_size=32, antigen_size=32,
                   remove_anchor=False)),
    'dock': dict(TINY_CFG, sampling={
        'cdrs': ['H_CDR3'], 'sample_structure': True,
        'sample_sequence': False}),
    'abopt': dict(TINY_CFG, mode='abopt', sampling={
        'cdrs': ['H_CDR3'], 'optimize_steps': [2, 3],
        'sample_structure': True, 'sample_sequence': True}),
}
T_FIXED = 4


@pytest.fixture(scope='module')
def pdb(tmp_path_factory):
    return write_synthetic_complex(
        str(tmp_path_factory.mktemp('cx') / 'cx.pdb'), seed=2)


@pytest.fixture(scope='module')
def jax_model():
    """The JAX DiffAb of TINY_MODEL and its params (init jitted once; every
    config here shares the architecture)."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    jmodel = JDiffAb(dict(TINY_MODEL))
    params = jax.jit(jmodel.init)(jax.random.key(0), synthetic_batch(
        np.random.default_rng(0), N=1, L=16, n_ab=10, gen_lo=3, gen_hi=6))
    return jmodel, params


def _fixed_out(batch_np, n, keep_traj):
    """What a sampler call returns, made from the batch's shape only."""
    aa = np.asarray(batch_np['aa'])
    Lp = aa.shape[1]
    rng = np.random.default_rng(1000 * n + Lp)
    gen = np.asarray(batch_np['generate_flag'][0]).astype(bool)
    g = int(gen.sum())
    pos = np.repeat(np.asarray(batch_np['pos_heavyatom'][:1], np.float32),
                    n, 0)
    pos[:, gen] = rng.normal(size=(n, g, 15, 3)).astype(np.float32) * 3.0
    mask = np.repeat(np.asarray(batch_np['mask_heavyatom'][:1]), n, 0)
    mask[:, gen] = np.arange(15) < 4
    s = np.repeat(aa[:1], n, 0).astype(np.int32)
    s[:, gen] = rng.integers(0, 20, (n, g))
    out = {'s': s, 'pos_atom_new': pos, 'mask_atom_new': mask,
           'v': rng.normal(size=(n, Lp, 3)).astype(np.float32),
           'p': pos[:, :, 1].copy(),
           'prmsd': rng.random((T_FIXED, n)).astype(np.float32) * 4.0,
           'perplexity': rng.random((T_FIXED, n)).astype(np.float32) + 1.0}
    if keep_traj:
        ca = pos[:, :, 1]
        out['traj'] = {
            'v': rng.normal(size=(T_FIXED, n, Lp, 3)).astype(np.float32) * 0.7,
            'p': (ca[None] + rng.normal(size=(T_FIXED, n, Lp, 3)) * 2.0
                  ).astype(np.float32),
            's': rng.integers(0, 20, (T_FIXED, n, Lp)).astype(np.int32)}
    return out


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path).read()
    return out


def _assert_traj_close(got, want, atol=2e-3):
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) and sum(x.startswith('MODEL') for x in g) == T_FIXED
    worst = 0.0
    for a, b in zip(g, w):
        if a.startswith('ATOM'):
            assert a[:30] == b[:30] and a[54:] == b[54:], (a, b)
            xa = np.array([float(a[i:i + 8]) for i in (30, 38, 46)])
            xb = np.array([float(b[i:i + 8]) for i in (30, 38, 46)])
            worst = max(worst, float(np.abs(xa - xb).max()))
        else:
            assert a == b
    assert worst <= atol, worst


@pytest.mark.parametrize('name', list(CONFIGS))
def test_design_for_pdb_writes_what_jax_writes(pdb, jax_model, tmp_path,
                                               monkeypatch, caplog, name):
    from ab_opt_tpu.runners import design as JD
    monkeypatch.setattr(
        JD.BatchedSampler, '__call__',
        lambda self, b, key, num_replicas=1: _fixed_out(b, num_replicas,
                                                       self.keep_traj))
    monkeypatch.setattr(
        TD.BatchedSampler, '__call__',
        lambda self, b, seed, num_replicas=1: _fixed_out(b, num_replicas,
                                                        self.keep_traj))
    cfg = CONFIGS[name]
    kw = dict(pdb_path=pdb, config=cfg, num_samples=5, batch_size=2, topk=2,
              keep_traj=True, run_dockq=True, seed=4)
    caplog.set_level('INFO', logger=TD.logger.name)
    got = TD.design_for_pdb(TD.DesignArgs(out_root=str(tmp_path / 'port'),
                                          device='cpu', **kw))
    want = JD.design_for_pdb(JD.DesignArgs(out_root=str(tmp_path / 'jax'),
                                           **kw), *jax_model)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    tp, tj = _tree(tmp_path / 'port'), _tree(tmp_path / 'jax')
    assert sorted(tp) == sorted(tj)
    n_pdb = sum(k.endswith('.pdb') for k in tp)
    assert n_pdb >= 7
    for k in tp:
        if k.endswith('traj.pdb'):
            _assert_traj_close(tp[k], tj[k])
        else:
            assert tp[k] == tj[k], k
    timed = re.findall(r'variant (\S+) timing \((\d+) samples\): sample=',
                       caplog.text)
    assert sorted(timed) == sorted((tag, '5') for tag in got)
    launched = re.findall(r'variant (\S+) kernel launches: K1=0 K5=0 K4=0',
                          caplog.text)
    assert sorted(launched) == sorted(got)


_BLOCK = '''
import importlib.abc, runpy, sys
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'chex', 'ab_opt_tpu')
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in BANNED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import torch
from ab_opt_tpu_torch.runners.design import load_model_from_checkpoint
model, cfg = load_model_from_checkpoint(sys.argv[1])
torch.save({'state_dict': model.state_dict(), 'layers': model.cfg.num_layers,
            'width': model.cfg.res_feat_dim, 'config': dict(cfg)}, sys.argv[2])
sys.argv = ['design_cli'] + sys.argv[3:]
runpy.run_module('ab_opt_tpu_torch.runners.design_cli', run_name='__main__')
bad = sorted(k for k in sys.modules if k.split('.')[0] in BANNED)
assert not bad, bad
print('clean')
'''


def _expected_tree(out_root, steps=4):
    out_dir = os.path.join(out_root, 'cx.pdb')
    assert os.path.isdir(out_dir)
    vdir = os.path.join(out_dir, 'H_CDR3')
    for f in ('REF1.pdb', '0000.pdb', '0002.pdb'):
        assert os.path.exists(os.path.join(vdir, f)), f
    for f in ('results.csv', 'aa.csv', 'traj.pdb', 'metadata.json'):
        assert os.path.exists(os.path.join(out_dir, f)), f
    assert open(os.path.join(out_dir, 'traj.pdb')).read().count(
        'MODEL ') == steps
    from ab_opt_tpu_torch.data import parse_pdb
    sample, _ = parse_pdb(os.path.join(vdir, '0000.pdb'))
    assert set(sample['chain_id']) == {'A', 'H'}
    return out_dir


def _cli_args(pdb, cfg_path, out_root, *extra):
    return ['--pdb_path', pdb, '-c', cfg_path, '-o', out_root, '-n', '3',
            '-b', '3', '--topk', '2', '--device', 'cpu', *extra]


def test_jax_checkpoint_loads_and_runs_without_jax(pdb, jax_model, tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint (config a
    JAX ConfigDict, an optax Adam state) is read in a process that cannot
    import JAX: the weights equal the weight bridge's, and the CLI runs
    from it."""
    import optax
    import yaml
    from ab_opt_tpu.train.checkpoint import save_checkpoint
    from ab_opt_tpu.utils.config import ConfigDict
    from ab_opt_tpu_torch.utils.convert import params_to_state_dict
    model_cfg = dict(TINY_MODEL, type='diffab')
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.01,
                                    jax_model[1])
    ckpt = str(tmp_path / 'jax.ckpt')
    save_checkpoint(ckpt, config=ConfigDict.wrap({'model': model_cfg,
                                                  'train': {'max_iters': 1}}),
                    params=params, opt_state=optax.adam(1e-4).init(params),
                    iteration=7)
    cfg_path = str(tmp_path / 'tiny.yml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(TINY_CFG, f)
    out = str(tmp_path / 'loaded.pt')
    out_root = str(tmp_path / 'out')
    run = subprocess.run(
        [sys.executable, '-c', _BLOCK, ckpt, out,
         *_cli_args(pdb, cfg_path, out_root, '--ckpt', ckpt)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith('clean')
    loaded = torch.load(out, weights_only=False)
    assert (loaded['layers'], loaded['width']) == (1, 16)
    assert loaded['config']['model'] == model_cfg
    want = params_to_state_dict(params)
    assert sorted(loaded['state_dict']) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(loaded['state_dict'][k], v, rtol=0,
                                   atol=0, msg=k)
    _expected_tree(out_root)


def test_port_checkpoint_loads(tmp_path):
    from ab_opt_tpu_torch.train.checkpoint import save_checkpoint
    model = TD.random_model(dict(TINY_MODEL, type='diffab'), seed=5)
    path = save_checkpoint(str(tmp_path / 'port.ckpt'),
                           config={'model': dict(TINY_MODEL)},
                           model=model.state_dict(), iteration=3)
    loaded, cfg = TD.load_model_from_checkpoint(path)
    assert cfg['model'] == TINY_MODEL and loaded.cfg == model.cfg
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


def test_design_cli_on_the_cpu_writes_the_tree(pdb, tmp_path):
    """The CLI as a user runs it, twice with one seed (renumbering on: the
    passthrough check, AbNumber being absent): the tree of
    tests/test_runner.py, finite scores, and the same files both times."""
    import yaml
    cfg_path = str(tmp_path / 'tiny.yml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(TINY_CFG, f)
    trees = []
    for i in range(2):
        out_root = str(tmp_path / f'run{i}')
        run = subprocess.run(
            [sys.executable, '-m', 'ab_opt_tpu_torch.runners.design_cli',
             *_cli_args(pdb, cfg_path, out_root)],
            cwd=REPO, capture_output=True, text=True, timeout=240)
        assert run.returncode == 0, run.stderr[-3000:]
        assert 'variant H_CDR3 timing (3 samples)' in run.stderr
        out_dir = _expected_tree(out_root)
        assert os.path.exists(os.path.join(out_root, 'cx.pdb_chothia.pdb'))
        import pandas as pd
        res = pd.read_csv(os.path.join(out_dir, 'results.csv'), index_col=0)
        for k in ('DockQ_mean', 'AAR_mean', 'prmsd_mean', 'PPL_mean',
                  'irms_mean', 'Lrms_mean', 'fnat_mean'):
            assert np.isfinite(res.loc['H_CDR3', k]), k
        assert 0 <= res.loc['H_CDR3', 'AAR_mean'] <= 1
        trees.append(_tree(out_dir))
    assert trees[0] == trees[1]


def test_registry_chunk_seeds_and_device_default():
    from ab_opt_tpu_torch.models import DiffAb, DiffGNN, get_model
    model = get_model(dict(TINY_MODEL, type='diffab'))
    assert isinstance(model, DiffAb) and model.cfg.num_layers == 1
    gnn = get_model({'type': 'diff_gnn', 'res_feat_dim': 8,
                     'edge_feat_dim': 8, 'hidden_size': 8, 'num_steps': 4,
                     'n_layers': 1})
    assert isinstance(gnn, DiffGNN) and gnn.cfg.num_steps == 4
    with pytest.raises(KeyError, match='no_such_model'):
        get_model({'type': 'no_such_model'})
    seeds = {TD.chunk_seed(s, lo) for s in range(4) for lo in range(0, 64, 16)}
    assert len(seeds) == 16
    assert TD.chunk_seed(0, 16) == TD.chunk_seed(0, 16)
    assert TD.DesignArgs(pdb_path='x').device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            TD.BatchedSampler(model)
