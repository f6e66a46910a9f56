"""The port's evaluation, relax and HDock tools (``tools/eval``,
``tools/relax``, ``tools/hdock.py``) against the JAX package's. Everything
here is host code on both sides, so every comparison is exact:

* ``reslist_rmsd`` on seeded random CA lists (M <= N and M > N) and
  ``eval_similarity`` on synthetic complexes and on a design tree's samples
  against their REF1.pdb, with and without a CDR's residue bounds;
* ``EvalTaskScanner.scan`` and ``evaluate_directory`` over a design tree
  the port's ``design_for_pdb`` writes (sampler patched to fixed arrays):
  the same tasks and the same summary.csv as the JAX package's, and a
  second call skips the visited tasks;
* an ``evaluation_db.pkl`` the JAX package wrote, read through
  ``python -m ab_opt_tpu_torch.tools.eval`` in a process that cannot
  import jax or the JAX package;
* the relax layer: ``TaskScanner.scan`` (the ``final_postfix`` skip, empty
  files left out), the ``RelaxTask`` state machine (the empty-file
  cleanup), ``available_backends``, ``relax_directory`` and the relax CLI
  raising without OpenMM/PyRosetta, ``run_pipeline`` serially; and on a
  pool of two processes, where the port returns the serial result while
  the JAX package's raises AttributeError: it hands the pool a nested
  function, which cannot be pickled;
* HDock: no binary here, so both packages raise; with the binary check
  patched, the same CDR-H3 ligand site and epitope receptor site, and
  ``cleanup`` removes the session's directory.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.tools import eval as TE  # noqa: E402
from ab_opt_tpu_torch.tools import hdock as TH  # noqa: E402
from ab_opt_tpu_torch.tools import relax as TR  # noqa: E402
from ab_opt_tpu_torch.tools.eval import similarity as TS  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_synthetic_complex)
from test_torch_design import _BLOCK, CONFIGS, _fixed_out  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The import blocker of tests/test_torch_design.py (jax, flax, optax and
# the JAX package cannot be imported below it).
FINDER = _BLOCK.split('import torch\n')[0]
H3 = (('H', 95, ' '), ('H', 102, ' '))


@pytest.fixture(scope='module')
def design_tree(tmp_path_factory):
    """A design tree of the port's design_for_pdb (codesign of H_CDR3 and
    L_CDR3, 3 samples each, the sampler patched to fixed arrays)."""
    root = tmp_path_factory.mktemp('design')
    pdb = write_synthetic_complex(str(root / 'cx.pdb'), seed=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD.BatchedSampler, '__call__',
                   lambda self, b, seed, num_replicas=1: _fixed_out(
                       b, num_replicas, False))
        TD.design_for_pdb(TD.DesignArgs(
            pdb_path=pdb, config=CONFIGS['codesign'], num_samples=3,
            batch_size=3, keep_traj=False, run_dockq=False, seed=3,
            out_root=str(root / 'out'), device='cpu'))
    return root / 'out'


@pytest.mark.parametrize('M,N', [(1, 1), (5, 9), (12, 12), (17, 6)])
def test_reslist_rmsd_equals_jax(M, N):
    from ab_opt_tpu.tools.eval.similarity import reslist_rmsd as J
    rng = np.random.default_rng(10 * M + N)
    a = rng.normal(size=(M, 3)) * 4.0
    b = rng.normal(size=(N, 3)) * 4.0
    got = TS.reslist_rmsd(a, b)
    assert got == J(a, b)
    assert got == TS.reslist_rmsd(b, a) and np.isfinite(got)


def _similarity_cases(tmp_path, design_tree):
    other = write_synthetic_complex(str(tmp_path / 'other.pdb'), seed=5,
                                    n_antigen=150)
    ref = write_synthetic_complex(str(tmp_path / 'ref.pdb'), seed=6)
    vdir = design_tree / 'cx.pdb' / 'H_CDR3'
    sample, native = str(vdir / '0001.pdb'), str(vdir / 'REF1.pdb')
    return [(other, ref, None, None), (sample, native, None, None),
            (sample, native) + H3, (sample, open(native).read()) + H3,
            (other, ref) + H3, (sample, native, ('H', 95, ' '), None),
            (sample, native, ('Z', 1, ' '), ('Z', 3, ' '))]


def test_eval_similarity_equals_jax(tmp_path, design_tree):
    from ab_opt_tpu.tools.eval.similarity import eval_similarity as J
    for case in _similarity_cases(tmp_path, design_tree):
        got = TE.eval_similarity(*case)
        assert got == J(*case), case[2:]
        assert np.isfinite(got['rmsd']) and 0 <= got['seqid'] <= 1


def test_eval_scan_and_evaluate_directory_equal_jax(design_tree):
    from ab_opt_tpu.tools.eval import pipeline as J
    root = str(design_tree)
    got = TE.EvalTaskScanner(root).scan()
    want = J.EvalTaskScanner(root).scan()
    assert len(got) == 6
    assert [dataclasses.asdict(t) for t in got] == [
        dataclasses.asdict(t) for t in want]
    assert {tuple(t.residue_first) for t in got} == {('H', 95, ' '),
                                                     ('L', 89, ' ')}

    summary = os.path.join(root, 'summary.csv')
    df_j = J.evaluate_directory(root, db_path=os.path.join(root, 'j.pkl'))
    want_csv = open(summary).read()
    os.unlink(summary)
    db = os.path.join(root, 'port.pkl')
    df = TE.evaluate_directory(root, db_path=db)
    assert open(summary).read() == want_csv
    assert df.equals(df_j) and len(df) == 6
    assert np.isfinite(df['rmsd']).all()

    # A second call scores nothing new and writes the same summary.
    assert TE.EvalTaskScanner(root, '', db).scan() == []
    again = TE.evaluate_directory(root, db_path=db)
    assert again.equals(df) and open(summary).read() == want_csv


def test_jax_eval_db_read_without_jax(design_tree, tmp_path):
    """The eval CLI over a tree whose evaluation_db.pkl the JAX package
    wrote, in a process that cannot import jax or the JAX package: it
    scans no task again and writes JAX's summary.csv from the db."""
    from ab_opt_tpu.tools.eval import evaluate_directory as J
    root = tmp_path / 'tree'
    shutil.copytree(design_tree, root)
    J(str(root))
    want = (root / 'summary.csv').read_text()
    (root / 'summary.csv').unlink()
    code = FINDER + '''
import runpy
from ab_opt_tpu_torch.tools.eval import EvalTaskScanner
root = sys.argv[1]
print('unscored', len(EvalTaskScanner(root, '', root + '/evaluation_db.pkl').scan()))
sys.argv = ['eval', '--root', root]
runpy.run_module('ab_opt_tpu_torch.tools.eval', run_name='__main__')
bad = sorted(k for k in sys.modules if k.split('.')[0] in BANNED)
assert not bad, bad
print('clean')
'''
    run = subprocess.run([sys.executable, '-c', code, str(root)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    assert 'unscored 0' in run.stdout and run.stdout.strip().endswith('clean')
    assert (root / 'summary.csv').read_text() == want


def _relax_tree(root):
    """Poses for the relax scanner: two finished under 'rosetta', an empty
    one, a patch file and a ligand file it must skip, and metadata."""
    d = root / 'cx' / 'H_CDR3'
    d.mkdir(parents=True)
    for name in ('0000.pdb', '0001.pdb', '0002.pdb', 'REF1.pdb',
                 '0001_rosetta.pdb', '0004_patch.pdb', 'ligand.pdb',
                 'REF1_rosetta.pdb'):
        (d / name).write_text('ATOM\n')
    (d / '0003.pdb').write_text('')
    (root / 'cx' / 'metadata.json').write_text(
        '{"items": [{"tag": "H_CDR3", "residue_first": ["H", 95, " "], '
        '"residue_last": ["H", 102, " "]}]}')
    return d


def _asdicts(tasks):
    return sorted((dataclasses.asdict(t) for t in tasks),
                  key=lambda t: t['in_path'])


@pytest.mark.parametrize('postfix', [None, 'rosetta', 'openmm'])
def test_relax_scanner_equals_jax(tmp_path, postfix):
    from ab_opt_tpu.tools.relax import TaskScanner as J
    _relax_tree(tmp_path)
    got = TR.TaskScanner(str(tmp_path), final_postfix=postfix).scan()
    want = J(str(tmp_path), final_postfix=postfix).scan()
    assert _asdicts(got) == _asdicts(want)
    names = sorted(os.path.basename(t.in_path) for t in got)
    assert names == {None: ['0000.pdb', '0001.pdb', '0002.pdb', 'REF1.pdb'],
                     'rosetta': ['0000.pdb', '0002.pdb'],
                     'openmm': ['0000.pdb', '0001.pdb', '0002.pdb',
                                'REF1.pdb']}[postfix]
    assert all(t.flexible_residue_first == ['H', 95, ' '] for t in got)


def _walk_states(task_cls, d):
    """The RelaxTask state machine through missing, empty, finished and
    fresh inputs: each step's (status, current_path, result) and the
    files left."""
    out = []
    for name in ('0000.pdb', '0001.pdb', '0003.pdb', '0009.pdb'):
        path = str(d / name)
        t = task_cls(in_path=path, current_path=path, info={})
        out.append((name, t.can_proceed(), t.status))
        out.append(t.update_if_finished('rosetta'))
        out.append((t.status, os.path.basename(t.current_path)))
        out.append(os.path.basename(t.set_current_path_tag('openmm')))
        out.append((t.check_current_path_exists(), t.status))
    out.append(sorted(os.listdir(d)))
    return out


def test_relax_task_states_equal_jax(tmp_path):
    from ab_opt_tpu.tools.relax import RelaxTask as J
    got = _walk_states(TR.RelaxTask, _relax_tree(tmp_path / 'port'))
    want = _walk_states(J, _relax_tree(tmp_path / 'jax'))
    assert got == want
    assert ('0003.pdb', False, 'failed') in got
    assert '0003.pdb' not in got[-1]        # the empty input was removed


def test_backends_and_relax_directory_raise_like_jax(tmp_path):
    from ab_opt_tpu.tools import relax as J
    from ab_opt_tpu_torch.tools.relax.__main__ import main as relax_cli
    assert TR.available_backends() == J.available_backends()
    _relax_tree(tmp_path)
    backends = TR.available_backends()
    for pipeline in ('openmm_pyrosetta', 'openmm', 'pyrosetta'):
        if all(backends[b] for b in backends if b in pipeline):
            continue
        for fn in (TR.relax_directory, J.relax_directory):
            with pytest.raises(RuntimeError, match='not installed'):
                fn(str(tmp_path), pipeline=pipeline, max_workers=0)
        with pytest.raises(RuntimeError, match='not installed'):
            relax_cli(['--root', str(tmp_path), '--pipeline', pipeline])


def _toy_stage(task):
    """A relax stage: <name>.pdb -> <name>_toy.pdb, failing on REF files."""
    if not task.can_proceed():
        return task
    if os.path.basename(task.in_path).startswith('REF'):
        task.status = 'failed'
        return task
    with open(task.path_with_tag('toy'), 'w') as f:
        f.write(open(task.current_path).read() + 'REMARK toy\n')
    task.set_current_path_tag('toy')
    task.status = 'success'
    return task


def _second_stage(task):
    task.info = dict(task.info, second=True)
    return task


def test_run_pipeline_serial_equals_jax(tmp_path):
    from ab_opt_tpu.tools import relax as J
    stages = [_toy_stage, _second_stage]
    got = TR.run_pipeline(TR.TaskScanner(str(_relax_tree(
        tmp_path / 'port'))).scan(), stages, max_workers=0)
    want = J.run_pipeline(J.TaskScanner(str(_relax_tree(
        tmp_path / 'jax'))).scan(), stages, max_workers=0)
    strip = lambda ts, root: [
        {k: str(v).replace(str(root), '') for k, v in t.items()}
        for t in _asdicts(ts)]
    assert strip(got, tmp_path / 'port') == strip(want, tmp_path / 'jax')
    assert sorted(t.status for t in got) == ['failed'] + ['success'] * 3
    assert all(bool(t.info.get('second')) == (t.status == 'success')
               for t in got)


def test_run_pipeline_on_a_pool(tmp_path):
    """Two worker processes: the port returns the serial result; the JAX
    package's pool cannot pickle its nested worker and raises."""
    from ab_opt_tpu.tools import relax as J
    stages = [_toy_stage, _second_stage]
    d = _relax_tree(tmp_path / 'pool')
    tasks = TR.TaskScanner(str(d)).scan()
    got = TR.run_pipeline(tasks, stages, max_workers=2)
    for f in d.glob('*_toy.pdb'):
        f.unlink()
    serial = TR.run_pipeline(TR.TaskScanner(str(d)).scan(), stages,
                             max_workers=0)
    assert _asdicts(got) == _asdicts(serial)
    with pytest.raises(AttributeError, match='local object'):
        J.run_pipeline(J.TaskScanner(str(d)).scan(), stages, max_workers=2)


def test_hdock_without_and_with_the_binary(tmp_path, monkeypatch):
    from ab_opt_tpu.tools import hdock as J
    assert TH.hdock_available() is J.hdock_available() is False
    for mod in (TH, J):
        with pytest.raises(RuntimeError, match='hdock/createpl'):
            mod.HDockAntibody()
    ab = write_synthetic_complex(str(tmp_path / 'ab.pdb'))
    sites = {}
    for mod in (TH, J):
        monkeypatch.setattr(mod, 'hdock_available', lambda: True)
        docker = mod.HDockAntibody()
        docker.set_antigen(ab, epitope_sites=[(170, 'A'), (171, 'A')])
        docker.set_antibody(ab, heavy_id='B')
        assert sorted(os.listdir(docker.tmpdir)) == ['ligand.pdb',
                                                     'receptor.pdb']
        sites[mod] = (docker._lsite, docker._rsite)
        docker.cleanup()
        assert not os.path.exists(docker.tmpdir)
    assert sites[TH] == sites[J]
    assert sites[TH][0].startswith('95:B, 96:B') and sites[TH][0].endswith(
        '102:B')
