"""The port's training CLI (``runners/train_cli.py``), its sampling-in-the-loop
eval (``train/sampling_eval.py``) and ``Trainer.train`` against the JAX
package's, on a mini-SAbDab of synthetic Chothia complexes that the test
writes (``utils/bench_fixture.py::write_mini_sabdab``):

* ``resolve_max_iters`` on a table of flags;
* ``evaluate_samples`` with both packages' samplers patched to return the
  same arrays (made from the batch's shape): the metrics, ``results.csv``
  and every dumped PDB byte for byte;
* ``BestCheckpointTracker``'s decisions and files;
* ``python -m ab_opt_tpu_torch.runners.train_cli --device cpu`` at a tiny
  ``codesign_single`` (2 layers, narrow widths, 4 steps, val every 2,
  sampling eval on), run twice with one seed: the log tree of the JAX CLI
  at the same config (file names), the same losses both times, and the
  SAbDab ids of the batches it trains on equal to those the JAX CLI trains
  on (which start at the loader's second epoch: the JAX CLI spends the
  first on the example batch of ``init_params``);
* ``--resume`` (continues at the saved iteration), ``--finetune`` of a port
  checkpoint and of a JAX one (``--finetune_iters``), ``--resume`` of a JAX
  checkpoint and ``--num_devices 2`` refused;
* every ``configs/train/*.yml`` and ``configs/debug.yml`` builds its
  datasets (items equal to the JAX package's) and its model: ``DiffAb``,
  or ``DiffGNN`` for the four ``diff_gnn`` configs, whose parameter count
  at full width equals that of JAX's ``DiffGNN.init`` on a batch with
  hotspot codes.

The loss values are not held against JAX here: the two packages draw the
initial weights and the noise from different generators.
``tests/test_torch_train.py`` holds one step of both with shared draws.
"""
import argparse
import copy
import glob
import os
import re

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip('jax')

from ab_opt_tpu_torch import data as T  # noqa: E402
from ab_opt_tpu_torch.data import loader as TL  # noqa: E402
from ab_opt_tpu_torch.models import DiffAb, DiffGNN, get_model  # noqa: E402
from ab_opt_tpu_torch.runners import train_cli as TC  # noqa: E402
from ab_opt_tpu_torch.train import sampling_eval as TE  # noqa: E402
from ab_opt_tpu_torch.train import trainer as TT  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_mini_sabdab)
from ab_opt_tpu_torch.utils.config import load_config  # noqa: E402
from test_torch_data import assert_same  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COMPLEXES = 32          # 2 test, 1 dock-test, 20 val, 9 train
BATCH, ITERS = 4, 4
# Every training config: configs/train/*.yml and configs/debug.yml (the
# graph model's developer recipe).
TRAIN_YMLS = sorted(glob.glob(os.path.join(REPO, 'configs', 'train',
                                           '*.yml'))) + [
    os.path.join(REPO, 'configs', 'debug.yml')]


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The mini-SAbDab and the tiny codesign_single config over it, one
    YAML a package (each with its own processed_dir)."""
    root = tmp_path_factory.mktemp('train_cli')
    paths = write_mini_sabdab(str(root), n=N_COMPLEXES)
    cfg = yaml.safe_load(open(os.path.join(REPO, 'configs', 'train',
                                           'codesign_single.yml')))
    cfg['model'].update(res_feat_dim=16, pair_feat_dim=8, num_bins=8)
    cfg['model']['diffusion'].update(num_steps=4,
                                     eps_net_opt={'num_layers': 2})
    cfg['train'].update(max_iters=ITERS, val_freq=2, batch_size=BATCH,
                        sampling_eval={'enabled': True, 'num_items': 2,
                                       'num_samples': 2})
    ymls = {}
    for pkg in ('jax', 'port'):
        c = copy.deepcopy(cfg)
        for split in ('train', 'val'):
            c['dataset'][split].update(
                paths, processed_dir=str(root / f'processed_{pkg}'))
            c['dataset'][split]['transform'][-1].update(
                initial_patch_size=16, antigen_size=16)
        ymls[pkg] = str(root / f'tiny_{pkg}.yml')
        with open(ymls[pkg], 'w') as f:
            yaml.safe_dump(c, f)
    return root, paths, ymls


class _FetchLog:
    """Wraps a loader module's ``_fetch_with_resample``: records
    (len(dataset), epoch, SAbDab id) of every item fetched, in order."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, ds, idx, epoch, seed, max_retries=32):
        self.calls.append((len(ds), epoch, ds.ids_in_split[idx]))
        return self.fn(ds, idx, epoch, seed, max_retries)

    def train_ids(self, n_train):
        """The ids of the train split's items after the first epoch."""
        return [sid for n, ep, sid in self.calls if n == n_train and ep >= 1]


def _tree(log_dir):
    """File names under a log dir, the config's own name and the best
    checkpoint's value and iteration masked."""
    out = set()
    for dirpath, _, files in os.walk(log_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), log_dir)
            rel = re.sub(r'^tiny_\w+\.yml$', 'CONFIG.yml', rel)
            out.add(re.sub(r'best_rmsd_[\d.]+_it\d+', 'best_rmsd_X', rel))
    return out


@pytest.fixture(scope='module')
def jax_run(mini, tmp_path_factory):
    """The JAX CLI once at the tiny config on one device: its log dir and
    the fetch log of its loaders. Its ``init_params`` is jitted (the same
    params, compiled once instead of run op by op) and its persistent
    compile cache is left off."""
    import ab_opt_tpu.utils as JU
    from ab_opt_tpu.data import loader as JL
    from ab_opt_tpu.data.collate import to_device_batch
    from ab_opt_tpu.runners import train_cli as JC
    from ab_opt_tpu.train import trainer as JT
    root, _, ymls = mini
    mp = pytest.MonkeyPatch()
    log = _FetchLog(JL._fetch_with_resample)

    def init_params(self, example_batch, seed=0):
        self.params = jax.jit(self.model.init)(
            jax.random.key(seed), to_device_batch(example_batch))
        self.opt_state = self.optimizer.init(self.params)
        return self.params

    try:
        mp.setattr(JU, 'enable_compile_cache', lambda *a, **k: None)
        mp.setattr(JL, '_fetch_with_resample', log)
        mp.setattr(JT.Trainer, 'init_params', init_params)
        trainer = JC.main(['--config', ymls['jax'], '--logdir',
                           str(root / 'jax_logs'), '--num_devices', '1',
                           '--seed', '7'])
    finally:
        mp.undo()
    assert trainer.iteration == ITERS
    return trainer.log_dir, log


def _port_cli(argv, monkeypatch):
    """The port's CLI on the CPU; returns (trainer, fetch log, losses of
    every step)."""
    log = _FetchLog(TL._fetch_with_resample)
    monkeypatch.setattr(TL, '_fetch_with_resample', log)
    losses = []
    step = TT.Trainer.train_step

    def recording_step(self, *args, **kw):
        out = step(self, *args, **kw)
        losses.append({k: float(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(TT.Trainer, 'train_step', recording_step)
    trainer = TC.main(argv + ['--device', 'cpu'])
    monkeypatch.undo()
    return trainer, log, losses


def test_resolve_max_iters_matches_jax():
    from ab_opt_tpu.runners.train_cli import resolve_max_iters as J
    config = {'train': {'max_iters': 500}}
    table = [({}, 0), ({}, 12), ({'finetune': 'x.ckpt', 'finetune_iters': 7}, 0),
             ({'finetune': 'x.ckpt', 'finetune_iters': 7}, 3),
             ({'finetune': 'x.ckpt', 'finetune_iters': 7, 'max_iters': 2}, 3),
             ({'resume': 'x.ckpt'}, 40), ({'max_iters': 9}, 0)]
    got = []
    for flags, restored in table:
        ns = argparse.Namespace(**dict(dict(
            max_iters=None, finetune=None, resume=None,
            finetune_iters=200_000), **flags))
        got.append(TC.resolve_max_iters(ns, config, restored))
        assert got[-1] == J(ns, config, restored), flags
    assert got == [500, 500, 7, 10, 2, 500, 9]


def _fixed_sample(batch):
    """What a sampler returns for ``batch``, made from its shape only."""
    N, L = np.asarray(batch['aa']).shape
    rng = np.random.default_rng(100 * N + L)
    return {'v': rng.normal(size=(N, L, 3)).astype(np.float32) * 0.5,
            'p': rng.normal(size=(N, L, 3)).astype(np.float32) * 4.0,
            's': rng.integers(0, 20, (N, L)).astype(np.int64)}


class _PortStub:
    def sample(self, batch, generator=None):
        return {k: torch.from_numpy(v) for k, v in _fixed_sample(
            {'aa': batch['aa'].numpy()}).items()}


class _JaxStub:
    def sample(self, params, batch, key):
        return _fixed_sample(batch)


def _files(d):
    return {f: open(os.path.join(d, f), 'rb').read()
            for f in sorted(os.listdir(d))}


def test_evaluate_samples_matches_jax(mini, tmp_path, monkeypatch):
    import ab_opt_tpu.utils.compile_cache as JCC
    from ab_opt_tpu.train.sampling_eval import evaluate_samples as J
    root, paths, _ = mini
    cfg, _ = load_config(os.path.join(REPO, 'configs', 'train',
                                      'codesign_single.yml'))
    ds = T.get_dataset(dict(cfg['dataset']['val'], **dict(
        paths, processed_dir=str(root / 'processed_port'))))
    items = [ds[i] for i in range(3)]
    monkeypatch.setattr(JCC, 'jit_sample', lambda fn: fn)
    got = TE.evaluate_samples(_PortStub(), items, seed=0, num_samples=2,
                              batch_size=2, out_dir=str(tmp_path / 'port'),
                              device='cpu')
    want = J(_JaxStub(), None, copy.deepcopy(items), jax.random.key(0),
             num_samples=2, batch_size=2, out_dir=str(tmp_path / 'jax'))
    assert got == want
    assert got['n'] == 6 and 'rmsd/H_CDR3' in got
    files = _files(tmp_path / 'port')
    assert files == _files(tmp_path / 'jax')
    # A dump is named by the chunk's start plus its row in the replicated
    # chunk, so the second chunk's two rows overwrite the first chunk's
    # last two, in both packages: four files for six samples.
    assert sum(f.endswith('.pdb') for f in files) == 4


def test_best_checkpoint_tracker_matches_jax(tmp_path):
    from ab_opt_tpu.train.sampling_eval import BestCheckpointTracker as J
    values = [5.0, 6.0, float('nan'), 4.25, 4.25, 3.5, 9.0]
    trackers = {'port': TE.BestCheckpointTracker(str(tmp_path / 'port')),
                'jax': J(str(tmp_path / 'jax'))}
    decisions = {}
    for name, tracker in trackers.items():
        os.makedirs(tracker.ckpt_dir)
        save = lambda path: open(path, 'w').close()
        decisions[name] = [tracker.update(v, save, it)
                           for it, v in enumerate(values)]
    assert decisions['port'] == decisions['jax']
    assert (os.listdir(tmp_path / 'port') == os.listdir(tmp_path / 'jax')
            == ['best_rmsd_3.500_it5.ckpt'])


def test_cli_trains_on_the_jax_stream(mini, jax_run, monkeypatch):
    root, _, ymls = mini
    jax_dir, jax_log = jax_run
    argv = ['--config', ymls['port'], '--seed', '7']
    runs = []
    for i in range(2):
        runs.append(_port_cli(argv + ['--logdir', str(root / f'port_{i}')],
                              monkeypatch))
    (first, log, losses), (second, _, losses_again) = runs
    assert first.iteration == second.iteration == ITERS
    assert len(losses) == ITERS
    assert losses == losses_again
    assert all(np.isfinite(v) for step in losses for v in step.values())

    tree = _tree(first.log_dir)
    assert tree == _tree(jax_dir) == _tree(second.log_dir)
    for want in ('CONFIG.yml', 'train.log', 'checkpoints/2.ckpt',
                 'checkpoints/4.ckpt', 'checkpoints/best_rmsd_X.ckpt',
                 'sampling_eval/it2/results.csv',
                 'sampling_eval/it4/0003_H_CDR3.pdb'):
        assert want in tree, want

    n_train = N_COMPLEXES - 23
    trained = ITERS * BATCH
    got = log.train_ids(n_train)[:trained]
    assert len(got) == trained
    assert got == jax_log.train_ids(n_train)[:trained]
    # The JAX CLI fetched its first epoch for the example batch only.
    assert any(n == n_train and ep == 0 for n, ep, _ in jax_log.calls)
    assert not any(n == n_train and ep == 0 for n, ep, _ in log.calls)


def test_cli_resume_and_finetune(mini, jax_run, tmp_path, monkeypatch):
    root, _, ymls = mini
    jax_dir, _ = jax_run
    base = ['--config', ymls['port'], '--logdir', str(tmp_path)]
    trainer, _, _ = _port_cli(base + ['--max_iters', '2'], monkeypatch)
    ckpt = os.path.join(trainer.log_dir, 'checkpoints', '2.ckpt')
    saved = torch.load(ckpt, map_location='cpu', weights_only=True)
    assert saved['iteration'] == 2

    resumed, _, losses = _port_cli(
        ['--config', ymls['port'], '--resume', ckpt, '--max_iters', '4'],
        monkeypatch)
    assert resumed.log_dir == trainer.log_dir
    assert resumed.iteration == 4 and len(losses) == 2
    assert os.path.exists(os.path.join(trainer.log_dir, 'checkpoints',
                                       '4.ckpt'))

    for src in (ckpt, os.path.join(jax_dir, 'checkpoints', '4.ckpt')):
        tuned, _, losses = _port_cli(
            base + ['--finetune', src, '--finetune_iters', '2'], monkeypatch)
        assert tuned.iteration == 2 and len(losses) == 2
        assert tuned.log_dir != trainer.log_dir

    with pytest.raises(ValueError, match='--finetune'):
        _port_cli(['--config', ymls['port'], '--resume',
                   os.path.join(jax_dir, 'checkpoints', '2.ckpt')],
                  monkeypatch)
    with pytest.raises(ValueError, match='torch.distributed'):
        TC.main(base + ['--num_devices', '2', '--device', 'cpu'])


def test_finetune_loads_the_jax_weights(mini, jax_run, monkeypatch):
    """A JAX checkpoint's weights reach the port model before training."""
    from ab_opt_tpu_torch.train.checkpoint import read_weights
    root, _, ymls = mini
    jax_dir, _ = jax_run
    src = os.path.join(jax_dir, 'checkpoints', '4.ckpt')
    seen = []
    monkeypatch.setattr(TT.Trainer, 'train',
                        lambda self, *a, **k: seen.append(
                            {k: v.clone() for k, v in
                             self.model.state_dict().items()}))
    TC.main(['--config', ymls['port'], '--logdir', str(root / 'ft'),
             '--finetune', src, '--device', 'cpu'])
    want = read_weights(src)['state_dict']
    assert sorted(seen[0]) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(seen[0][k], v.float(), rtol=0, atol=0)


@pytest.mark.parametrize('yml', TRAIN_YMLS,
                         ids=[os.path.basename(p) for p in TRAIN_YMLS])
def test_train_configs_build(mini, yml):
    from ab_opt_tpu.data import get_dataset as J
    from ab_opt_tpu.data.loader import _fetch_with_resample as Jfetch
    root, paths, _ = mini
    cfg, _ = load_config(yml)
    model = get_model(cfg['model'])
    if cfg['model']['type'] == 'diff_gnn':
        assert isinstance(model, DiffGNN)
        assert _n_params(model) == _jax_gnn_params(cfg['model'])
    else:
        assert isinstance(model, DiffAb)
    for split in ('train', 'val'):
        ds_cfg = dict(cfg['dataset'][split])
        got = T.get_dataset(dict(ds_cfg, **dict(
            paths, processed_dir=str(root / 'processed_port'))))
        want = J(dict(ds_cfg, **dict(
            paths, processed_dir=str(root / 'processed_jax'))))
        assert got.ids_in_split == want.ids_in_split
        outcomes = [_fetch_first(fetch, ds) for fetch, ds in
                    ((TL._fetch_with_resample, got), (Jfetch, want))]
        assert_same(*outcomes, f'{split}[0]')


def _n_params(model):
    return sum(p.numel() for p in model.parameters())


def _jax_gnn_params(model_cfg):
    """The parameter count of JAX's DiffGNN.init at ``model_cfg`` on a tiny
    batch with hotspot codes (shapes only: ``jax.eval_shape``)."""
    from ab_opt_tpu.models import DiffGNN as JDiffGNN
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    batch = {k: v.numpy() for k, v in synthetic_batch(
        np.random.default_rng(0), N=1, L=16, n_ab=10, gen_lo=3,
        gen_hi=6).items()}
    batch['hotspot_label'] = np.ones_like(batch['aa'])
    jm = JDiffGNN(dict(model_cfg))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), batch)
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))


def _fetch_first(fetch, ds):
    """Item 0 as the loader fetches it, or the loader's refusal (the
    contiguous-antigen crop rejects every synthetic antigen, whose rows
    are not one chain segment)."""
    try:
        return fetch(ds, 0, 0, 0)
    except RuntimeError as e:
        return ('RuntimeError', str(e))
