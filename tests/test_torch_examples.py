"""The port's notebook walkthrough (``ab_opt_tpu_torch/examples/``) against
the repository's JAX one (``examples/ab_opt_pipeline.py``,
``examples/ab_opt_analysis.py``):

* the analysis on the screening tree of ``tests/test_tools.py`` and a
  stage-1 tree: screening_df.csv, sequence_logo.csv,
  mutation_candidates.csv and summary.csv byte for byte, ``aa_counts``
  and ``summarize_seq_design`` equal, both plots drawn;
* the pipeline at smoke size on a synthetic complex, both packages'
  samplers patched to the same fixed arrays (and JAX's init to one jitted
  set of params): the pose, stage-1 and stage-2 trees byte for byte,
  screening_summary.csv among them;
* ``python -m ab_opt_tpu_torch.examples.ab_opt_pipeline --device cpu``
  through the real sampler (the kernels' plain versions), then
  ``.ab_opt_analysis`` on its output, in a process that cannot import jax
  or the JAX package; without ``--device`` the pipeline needs the card.
"""
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch.examples import ab_opt_analysis as TA  # noqa: E402
from ab_opt_tpu_torch.examples import ab_opt_pipeline as TP  # noqa: E402
from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_synthetic_complex)
from test_torch_design import _BLOCK, _fixed_out, _tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINDER = _BLOCK.split('import torch\n')[0]
ANALYSIS_CSVS = ('screening_df.csv', 'sequence_logo.csv',
                 'mutation_candidates.csv')


def _jax_example(name):
    """``examples/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', os.path.join(REPO, 'examples', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _screening_tree(root):
    """tests/test_tools.py::test_screening_analysis's four candidates."""
    rng = np.random.default_rng(0)
    for i in range(4):
        d = root / f'cand{i}'
        d.mkdir(parents=True)
        dockq = [round(float(x), 3) for x in rng.uniform(0.2, 0.8, 5)]
        prmsd = [round(float(x), 3) for x in rng.uniform(2, 9, 5)]
        (d / 'results.csv').write_text(
            ',DockQ_mean,DockQ_std,prmsd_mean,prmsd_std,AAR_mean,'
            'DockQ_all,prmsd_all\n'
            f'H_CDR3,{np.mean(dockq):.3f},{np.std(dockq):.3f},'
            f'{np.mean(prmsd):.3f},{np.std(prmsd):.3f},0.4,'
            f'"{dockq}","{prmsd}"\n')
        (d / 'aa.csv').write_text(
            'Region,native_aa,sampled_aa,AAR,PPL\n'
            f'H_CDR3,YCARDLGI,{"ACDEFGHI" if i % 2 else "YCARDLGI"},0.5,0.1\n')


def _seq_tree(root):
    for name, vals in {'candA': [0.8, 0.6], 'candB': [0.2, 0.4],
                       'candC': [0.5]}.items():
        d = root / name
        d.mkdir(parents=True)
        lines = ['Region,native_aa,sampled_aa,AAR,PPL'] + [
            f'H_CDR3,YCARDLGI,ACDEFGHI,{v},0.1' for v in vals]
        (d / 'aa.csv').write_text('\n'.join(lines) + '\n')
    (root / 'no_csv_dir').mkdir()


def test_analysis_writes_what_jax_writes(tmp_path):
    J = _jax_example('ab_opt_analysis')
    for pkg in ('port', 'jax'):
        _screening_tree(tmp_path / pkg / 'screen')
        _seq_tree(tmp_path / pkg / 'seq')
    runs = {pkg: mod.main(['--screen_dir', str(tmp_path / pkg / 'screen'),
                           '--seq_design_dir', str(tmp_path / pkg / 'seq')])
            for pkg, mod in (('port', TA), ('jax', J))}
    assert runs['port'].equals(runs['jax']) and len(runs['port']) == 4
    for name in ANALYSIS_CSVS:
        got, want = (open(tmp_path / pkg / 'screen' / 'analysis' / name).read()
                     for pkg in ('port', 'jax'))
        assert got == want, name
    for name in ('sequence_logo.png', 'screening_distributions.png'):
        assert (tmp_path / 'port' / 'screen' / 'analysis' / name).stat(
            ).st_size > 0, name
    assert ((tmp_path / 'port' / 'seq' / 'summary.csv').read_text()
            == (tmp_path / 'jax' / 'seq' / 'summary.csv').read_text())
    got = TA.summarize_seq_design(str(tmp_path / 'port' / 'seq'))
    assert got.equals(J.summarize_seq_design(str(tmp_path / 'jax' / 'seq')))
    assert list(got['pdb_id']) == ['candB', 'candC', 'candA']
    seqs = list(runs['port']['aa']) + ['', None, 'WXYZ', 'ACD']
    np.testing.assert_array_equal(TA.aa_counts(seqs), J.aa_counts(seqs))
    assert TA.aa_counts([]).shape == J.aa_counts([]).shape == (0, 20)
    assert TA.AA_ORDER == J.AA_ORDER


@pytest.fixture(scope='module')
def smoke_params():
    """One jitted init of the JAX smoke model, patched in for JAX's
    random init: both stages' models share its architecture."""
    from ab_opt_tpu.models import DiffAb as J
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    model = J(TP.smoke_model_cfg())
    return jax.jit(model.init)(jax.random.key(0), synthetic_batch(
        np.random.default_rng(0), N=1, L=16, n_ab=10, gen_lo=3, gen_hi=6))


def test_pipeline_writes_what_jax_writes(tmp_path, monkeypatch, smoke_params):
    from ab_opt_tpu.models.diffab import DiffAb as JDiffAb
    from ab_opt_tpu.runners import design as JD
    J = _jax_example('ab_opt_pipeline')
    assert J.smoke_model_cfg() == TP.smoke_model_cfg()
    monkeypatch.setattr(JDiffAb, 'init', lambda self, key, b: smoke_params)
    monkeypatch.setattr(
        JD.BatchedSampler, '__call__',
        lambda self, b, key, num_replicas=1: _fixed_out(b, num_replicas,
                                                       self.keep_traj))
    monkeypatch.setattr(
        TD.BatchedSampler, '__call__',
        lambda self, b, seed, num_replicas=1: _fixed_out(b, num_replicas,
                                                        self.keep_traj))
    pdb = write_synthetic_complex(str(tmp_path / 'cx.pdb'), seed=7)
    args = ['--pdb', pdb, '--num_poses', '2', '--num_designs', '2',
            '--num_screens', '3', '--contig', '2-4']
    df = TP.main(args + ['--out', str(tmp_path / 'port'), '--device', 'cpu'])
    monkeypatch.setattr(sys, 'argv', ['ab_opt_pipeline'] + args
                        + ['--out', str(tmp_path / 'jax')])
    J.main()
    tp, tj = _tree(tmp_path / 'port'), _tree(tmp_path / 'jax')
    assert sorted(tp) == sorted(tj)
    for k in tp:
        assert tp[k] == tj[k], k
    assert sum(k.startswith('poses/input/H_CDR3/0') for k in tp) == 2
    assert 'seq_design/0001_0001/H_CDR3/0001.pdb' in tp
    assert sum(k.startswith('screen/') and k.endswith('.pdb')
               and '/REF' not in k for k in tp) == 2 * 2 * 3
    summary = pd.read_csv(tmp_path / 'port' / 'screen' /
                          'screening_summary.csv')
    assert len(df) == len(summary) == 4
    assert df['candidate'].tolist() == summary['candidate'].tolist()
    assert np.isfinite(df[['DockQ_avg', 'prmsd_avg']].to_numpy()).all()


def test_the_walkthrough_runs_without_jax_and_needs_the_card(tmp_path):
    pdb = write_synthetic_complex(str(tmp_path / 'cx.pdb'), seed=3)
    out = tmp_path / 'walk'
    code = FINDER + f'''
import runpy
argv = sys.argv[1:]
sys.argv = ['ab_opt_pipeline'] + argv
runpy.run_module('ab_opt_tpu_torch.examples.ab_opt_pipeline',
                 run_name='__main__')
sys.argv = ['ab_opt_analysis', '--screen_dir', {str(out / 'screen')!r},
            '--seq_design_dir', {str(out / 'seq_design')!r}]
runpy.run_module('ab_opt_tpu_torch.examples.ab_opt_analysis',
                 run_name='__main__')
bad = sorted(k for k in sys.modules if k.split('.')[0] in BANNED)
assert not bad, bad
print('clean')
'''
    run = subprocess.run(
        [sys.executable, '-c', code, '--pdb', pdb, '--out', str(out),
         '--num_poses', '2', '--num_designs', '1', '--num_screens', '2',
         '--device', 'cpu'],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith('clean')
    assert '[3/3] screening summary' in run.stdout
    df = pd.read_csv(out / 'screen' / 'screening_summary.csv')
    assert len(df) == 2
    assert np.isfinite(df[['DockQ_avg', 'prmsd_avg', 'AAR']].to_numpy()).all()
    analysis = pd.read_csv(out / 'screen' / 'analysis' / 'screening_df.csv')
    assert len(analysis) == 2
    assert len(pd.read_csv(out / 'seq_design' / 'summary.csv')) == 2
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default runs there')
    shutil.rmtree(out)
    with pytest.raises(RuntimeError, match='CUDA'):
        TP.main(['--pdb', pdb, '--out', str(out), '--num_poses', '1'])
