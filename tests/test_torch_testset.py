"""The port's test-set runner (``runners/testset.py``) against the JAX
package's, on a mini-SAbDab of synthetic Chothia complexes that the test
writes (``utils/bench_fixture.py::write_mini_sabdab`` with n=3: entries 0
and 1 form the ``test`` split, entry 2 the ``dock_test`` split), each
package reading its own ``processed_dir``:

* ``design_for_testset`` with ``configs/test/codesign_single.yml`` on the
  test split and ``seq_design_dock_testset.yml`` on the dock-test split,
  their models cut to a tiny width, both packages' ``BatchedSampler``
  patched to return the same fixed arrays: the returned summary, every
  complex's tree, ``testset_results.csv`` and ``testset_summary.csv`` byte
  for byte; with ``relax=True`` both log the backend skip and write the
  same files;
* ``python -m ab_opt_tpu_torch.runners.testset --device cpu`` through the
  real sampler (the kernels' plain versions) in a process that cannot
  import jax or the JAX package;
* without ``--device`` (or ``device=``) the runner raises the card's
  error here instead of running on the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch.data import sabdab as TS  # noqa: E402
from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.runners import testset as TT  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_mini_sabdab)
from ab_opt_tpu_torch.utils.config import load_config  # noqa: E402
from test_torch_design import _BLOCK, _fixed_out, _tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COMPLEXES = 3           # 2 test, 1 dock-test
# The configs' own crops and modes; the widths, depth and steps cut.
TINY = {'res_feat_dim': 16, 'pair_feat_dim': 8, 'num_bins': 8}
SPLITS = {'codesign_single': 2, 'seq_design_dock_testset': 1}
FINDER = _BLOCK.split('import torch\n')[0]


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The mini-SAbDab, a processed_dir written by each package."""
    from ab_opt_tpu.data.sabdab import SAbDabDataset as J
    root = tmp_path_factory.mktemp('sabdab')
    paths = write_mini_sabdab(str(root), n=N_COMPLEXES)
    common = dict(summary_path=paths['summary_path'],
                  chothia_dir=paths['chothia_dir'], num_workers=1)
    J(processed_dir=str(root / 'jax'), **common)
    TS.SAbDabDataset(processed_dir=str(root / 'port'), **common)
    return root, paths


@pytest.fixture(scope='module')
def jax_params():
    """Parameters of the tiny JAX DiffAb (init jitted once): the JAX runner
    initialises its random model lazily, and its sampler is patched."""
    from ab_opt_tpu.models import DiffAb as J
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    model = J(_config('codesign_single', {})['model'])
    return jax.jit(model.init)(jax.random.key(0), synthetic_batch(
        np.random.default_rng(0), N=1, L=16, n_ab=10, gen_lo=3, gen_hi=6))


def _config(name, paths, package='port', steps=4, layers=1):
    cfg, _ = load_config(os.path.join(REPO, 'configs', 'test', f'{name}.yml'))
    cfg = json.loads(json.dumps(dict(cfg)))
    cfg['model'].update(TINY)
    cfg['model']['diffusion'].update(num_steps=steps,
                                     eps_net_opt={'num_layers': layers})
    if paths:
        root, p = paths
        cfg['dataset']['test'].update(p, processed_dir=str(root / package))
    return cfg


@pytest.fixture
def patched(monkeypatch, jax_params):
    from ab_opt_tpu.models.diffab import DiffAb as JDiffAb
    from ab_opt_tpu.runners import design as JD
    monkeypatch.setattr(JDiffAb, 'init', lambda self, key, batch: jax_params)
    monkeypatch.setattr(
        JD.BatchedSampler, '__call__',
        lambda self, b, key, num_replicas=1: _fixed_out(b, num_replicas,
                                                       self.keep_traj))
    monkeypatch.setattr(
        TD.BatchedSampler, '__call__',
        lambda self, b, seed, num_replicas=1: _fixed_out(b, num_replicas,
                                                        self.keep_traj))


@pytest.mark.parametrize('relax', [False, True])
@pytest.mark.parametrize('name', list(SPLITS))
def test_design_for_testset_writes_what_jax_writes(mini, patched, tmp_path,
                                                   caplog, name, relax):
    from ab_opt_tpu.runners import testset as JT
    kw = dict(num_samples=3, batch_size=2, topk=2, seed=4, relax=relax)
    caplog.set_level('WARNING')
    got = TT.design_for_testset(_config(name, mini, 'port'),
                                out_root=str(tmp_path / 'port'),
                                device='cpu', **kw)
    want = JT.design_for_testset(_config(name, mini, 'jax'),
                                 out_root=str(tmp_path / 'jax'), **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    tp, tj = _tree(tmp_path / 'port'), _tree(tmp_path / 'jax')
    assert sorted(tp) == sorted(tj)
    for k in tp:
        assert tp[k] == tj[k], k
    ids = sorted({k.split(os.sep)[0] for k in tp if os.sep in k})
    assert len(ids) == SPLITS[name]
    assert sum(k.endswith('.pdb') for k in tp) == SPLITS[name] * 4
    import pandas as pd
    res = pd.read_csv(tmp_path / 'port' / 'testset_results.csv')
    assert sorted(res['id']) == ids and np.isfinite(
        res.select_dtypes('number').to_numpy()).all()
    assert np.isfinite(got['DockQ_mean']) and np.isfinite(got['AAR_mean'])
    skips = [r for r in caplog.records if r.getMessage().startswith(
        '[relax] skipped for')]
    assert len(skips) == (2 * SPLITS[name] if relax else 0)
    assert sorted(r.name for r in skips) == sorted(
        [TT.logger.name, JT.logger.name] * (SPLITS[name] if relax else 0))


def test_testset_cli_on_the_cpu_without_jax(mini, tmp_path):
    cfg_path = tmp_path / 'tiny.yml'
    cfg_path.write_text(yaml.safe_dump(_config('codesign_single', mini)))
    out_root = tmp_path / 'out'
    code = FINDER + '''
import runpy
sys.argv = ['testset'] + sys.argv[1:]
runpy.run_module('ab_opt_tpu_torch.runners.testset', run_name='__main__')
bad = sorted(k for k in sys.modules if k.split('.')[0] in BANNED)
assert not bad, bad
print('clean')
'''
    run = subprocess.run(
        [sys.executable, '-c', code, '-c', str(cfg_path), '-o',
         str(out_root), '-n', '2', '-b', '2', '--limit', '1', '--device',
         'cpu'], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith('clean')
    assert 'variant H_CDR3 timing (2 samples)' in run.stderr
    import pandas as pd
    res = pd.read_csv(out_root / 'testset_results.csv')
    summ = pd.read_csv(out_root / 'testset_summary.csv')
    assert len(res) == 1 and res['tag'][0] == 'H_CDR3'
    assert np.isfinite(res.select_dtypes('number').to_numpy()).all()
    assert np.isfinite(summ.to_numpy(float)).all()
    sid = res['id'][0]
    for f in ('results.csv', 'aa.csv', 'metadata.json', 'H_CDR3/REF1.pdb',
              'H_CDR3/0000.pdb', 'H_CDR3/0001.pdb'):
        assert (out_root / sid / f).exists(), f


def test_testset_needs_the_card_unless_told(mini, tmp_path):
    assert TD.DesignArgs(pdb_path='').device is None
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default runs there')
    cfg_path = tmp_path / 'tiny.yml'
    cfg_path.write_text(yaml.safe_dump(_config('codesign_single', mini)))
    out = tmp_path / 'out'
    with pytest.raises(RuntimeError, match='CUDA'):
        TT.main(['-c', str(cfg_path), '-o', str(out), '-n', '1'])
    with pytest.raises(RuntimeError, match='CUDA'):
        TT.design_for_testset(_config('codesign_single', mini),
                              out_root=str(out))
    assert not out.exists()
