"""The port's antibody-optimization pipeline (``runners/optimize.py``) and
design-dock (``runners/design_dock.py``) against the JAX package's, on
poses from a docking request on a synthetic Chothia complex the test
writes (heavy H, light L, antigen A):

* ``scan_poses`` with and without ``suffix`` and ``max_poses``;
* ``optimize_antibody`` with ``configs/test/seq_design.yml`` and
  ``dock_cdr.yml`` (their models cut to a tiny width), ``max_poses=1``,
  ``num_designs=2``, ``nums=2`` and the contig ``2-4``, both packages'
  ``BatchedSampler`` patched to return the same fixed arrays: the returned
  table, the stage-1 and stage-2 trees and ``screening_summary.csv`` byte
  for byte;
* ``design_dock`` with HDock's binary check patched and its ``dock``
  copying two synthetic poses into the session's directory: the same
  results and trees, and the directory removed afterwards; without the
  binary both raise;
* ``python -m ab_opt_tpu_torch.runners.optimize --device cpu`` through the
  real sampler (the kernels' plain versions) in a process that cannot
  import jax or the JAX package; without ``--device`` the optimize and
  design-dock entry points raise the card's error here.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.runners import design_dock as TDD  # noqa: E402
from ab_opt_tpu_torch.runners import optimize as TO  # noqa: E402
from ab_opt_tpu_torch.tools import hdock as TH  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_synthetic_complex)
from test_torch_design import _BLOCK, CONFIGS, _fixed_out, _tree  # noqa: E402
from test_torch_testset import _config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINDER = _BLOCK.split('import torch\n')[0]
SEQ, DOCK = _config('seq_design', {}), _config('dock_cdr', {})
STAGE_ARGS = dict(heavy_chain_id='H', design_contig='2-4', nums=2,
                  num_designs=2, max_poses=1, seed=0, batch_size=2)


@pytest.fixture(scope='module')
def poses(tmp_path_factory):
    """Three poses of a dock_cdr request on the synthetic complex (the
    port's design_for_pdb, its sampler patched to fixed arrays)."""
    root = tmp_path_factory.mktemp('poses')
    pdb = write_synthetic_complex(str(root / 'cx.pdb'), seed=7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD.BatchedSampler, '__call__',
                   lambda self, b, seed, num_replicas=1: _fixed_out(
                       b, num_replicas, False))
        TD.design_for_pdb(TD.DesignArgs(
            pdb_path=pdb, config=DOCK, num_samples=3, batch_size=3,
            keep_traj=False, run_dockq=False, seed=0, id='cx',
            out_root=str(root / 'out'), device='cpu'))
    return root / 'out' / 'cx' / 'H_CDR3'


@pytest.fixture(scope='module')
def jax_params():
    from ab_opt_tpu.models import DiffAb as J
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    model = J(dict(DOCK['model']))
    return jax.jit(model.init)(jax.random.key(0), synthetic_batch(
        np.random.default_rng(0), N=1, L=16, n_ab=10, gen_lo=3, gen_hi=6))


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


def test_scan_poses_equals_jax(tmp_path, poses):
    from ab_opt_tpu.runners.optimize import scan_poses as J
    for name in ('0000.pdb', '0001.pdb', '0000_rosetta.pdb', '0001_rosetta.pdb',
                 '0002_openmm.pdb', 'REF1.pdb', 'x0003.pdb'):
        (tmp_path / name).write_text('x')
    for kw in ({}, {'suffix': 'rosetta'}, {'max_poses': 1},
               {'suffix': 'rosetta', 'max_poses': 1}, {'suffix': 'openmm'},
               {'max_poses': 0}):
        got = TO.scan_poses(str(tmp_path), **kw)
        assert got == J(str(tmp_path), **kw), kw
    assert [os.path.basename(p) for p in TO.scan_poses(str(tmp_path))] == [
        '0000.pdb', '0001.pdb']
    assert len(TO.scan_poses(str(tmp_path), suffix='rosetta')) == 2
    assert TO.scan_poses(str(poses)) == J(str(poses))
    assert len(TO.scan_poses(str(poses))) == 3


def test_optimize_antibody_writes_what_jax_writes(poses, patched, tmp_path):
    from ab_opt_tpu.runners import optimize as JO
    dirs = lambda pkg: dict(seq_design_dir=str(tmp_path / pkg / 'seq'),
                            screen_dir=str(tmp_path / pkg / 'screen'))
    got = TO.optimize_antibody(TO.OptimizeArgs(
        docked_pose_dir=str(poses), design_config=SEQ, dock_config=DOCK,
        device='cpu', **dirs('port'), **STAGE_ARGS))
    want = JO.optimize_antibody(JO.OptimizeArgs(
        docked_pose_dir=str(poses), design_config=SEQ, dock_config=DOCK,
        **dirs('jax'), **STAGE_ARGS))
    assert got.equals(want)
    assert len(got) == 2 and list(got.columns) == [
        'candidate', 'DockQ_avg', 'DockQ_std', 'prmsd_avg', 'prmsd_std',
        'AAR', 'confident', 'selected']
    assert np.isfinite(got[['DockQ_avg', 'prmsd_avg']].to_numpy()).all()
    assert sorted(got['candidate']) == [
        f'0000_0000__H_CDR3__000{i}/H_CDR3' for i in range(2)]
    tp, tj = _tree(tmp_path / 'port'), _tree(tmp_path / 'jax')
    assert sorted(tp) == sorted(tj)
    for k in tp:
        assert tp[k] == tj[k], k
    stage1 = sorted(k for k in tp if k.startswith('seq/'))
    assert 'seq/0000_0000/H_CDR3/0001.pdb' in stage1
    assert 'screen/screening_summary.csv' in tp
    assert sum(k.startswith('screen/') and k.endswith('.pdb')
               for k in tp) == 2 * 3


def _dock_patch(mod, monkeypatch, pose_src, tmpdirs):
    def dock(self, num_poses=10):
        tmpdirs.append(self.tmpdir)
        out = []
        for i, src in enumerate(pose_src[:num_poses]):
            out.append(os.path.join(self.tmpdir, f'model_{i + 1}.pdb'))
            shutil.copyfile(src, out[-1])
        return out
    monkeypatch.setattr(mod, 'hdock_available', lambda: True)
    monkeypatch.setattr(mod.HDock, 'dock', dock)


def test_design_dock_writes_what_jax_writes(patched, tmp_path, monkeypatch):
    from ab_opt_tpu.runners import design_dock as JDD
    from ab_opt_tpu.tools import hdock as JH
    ab = write_synthetic_complex(str(tmp_path / 'ab.pdb'), seed=3)
    kw = dict(config=CONFIGS['dock'], num_docks=2, num_samples=2,
              batch_size=2, seed=1)
    for run in (lambda: TDD.design_dock(ab, ab, device='cpu', **kw),
                lambda: JDD.design_dock(ab, ab, **kw)):
        with pytest.raises(RuntimeError, match='hdock/createpl'):
            run()
    src = [write_synthetic_complex(str(tmp_path / f'p{i}.pdb'), seed=10 + i)
           for i in range(2)]
    tmpdirs = []
    _dock_patch(TH, monkeypatch, src, tmpdirs)
    _dock_patch(JH, monkeypatch, src, tmpdirs)
    got = TDD.design_dock(ab, ab, out_root=str(tmp_path / 'port'),
                          device='cpu', **kw)
    want = JDD.design_dock(ab, ab, out_root=str(tmp_path / 'jax'), **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert len(got) == 2
    tp, tj = _tree(tmp_path / 'port'), _tree(tmp_path / 'jax')
    assert sorted(tp) == sorted(tj)
    for k in tp:
        assert tp[k] == tj[k], k
    assert 'pose001_dock001/H_CDR3/0001.pdb' in tp
    assert len(tmpdirs) == 2 and not any(map(os.path.exists, tmpdirs))


def _write_cfgs(tmp_path):
    paths = {}
    for name, cfg in (('seq', SEQ), ('dock', DOCK)):
        paths[name] = tmp_path / f'{name}.yml'
        paths[name].write_text(yaml.safe_dump(cfg))
    return paths


def test_optimize_cli_on_the_cpu_without_jax(poses, tmp_path):
    cfgs = _write_cfgs(tmp_path)
    code = FINDER + '''
import runpy
sys.argv = ['optimize'] + sys.argv[1:]
runpy.run_module('ab_opt_tpu_torch.runners.optimize', run_name='__main__')
bad = sorted(k for k in sys.modules if k.split('.')[0] in BANNED)
assert not bad, bad
print('clean')
'''
    screen = tmp_path / 'screen'
    run = subprocess.run(
        [sys.executable, '-c', code, '--docked_pose_dir', str(poses),
         '--seq_design_dir', str(tmp_path / 'seq'), '--screen_dir',
         str(screen), '--design_config', str(cfgs['seq']), '--dock_config',
         str(cfgs['dock']), '--design_contig', '2-4', '--nums', '2',
         '--num_designs', '2', '--max_poses', '1', '--device', 'cpu'],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith('clean')
    import pandas as pd
    df = pd.read_csv(screen / 'screening_summary.csv')
    assert len(df) == 2
    assert np.isfinite(df[['DockQ_avg', 'prmsd_avg', 'AAR']].to_numpy()).all()
    assert (tmp_path / 'seq' / '0000_0000' / 'H_CDR3' / '0001.pdb').exists()


def test_optimize_and_design_dock_need_the_card_unless_told(poses, tmp_path):
    assert TO.OptimizeArgs('a', 'b', 'c').device is None
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default runs there')
    cfgs = _write_cfgs(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA'):
        TO.main(['--docked_pose_dir', str(poses), '--seq_design_dir',
                 str(tmp_path / 'seq'), '--screen_dir', str(tmp_path / 's'),
                 '--design_config', str(cfgs['seq']), '--dock_config',
                 str(cfgs['dock'])])
    with pytest.raises(RuntimeError, match='CUDA'):
        TDD.main(['--antigen', str(poses / '0000.pdb'), '--antibody',
                  str(poses / '0000.pdb'), '-c', str(cfgs['dock']),
                  '-o', str(tmp_path / 'dd')])
    assert not (tmp_path / 'seq').exists() and not (tmp_path / 'dd').exists()
