"""The port's data loader (``ab_opt_tpu_torch/data/loader.py``) against the
JAX package's, on the items of ``configs/train/codesign_single.yml``'s
train transform over synthetic Chothia complexes (numpy on both sides, so
batches are compared exactly):

* two epochs of batches, shuffled and in order, with ``pad_partial`` and
  ``drop_last``, each package's ``TransformedDataset`` and collate;
* the port's ``num_workers=2`` stream (a forkserver pool) equal to its own
  ``num_workers=0`` stream, under a per-test timeout (the JAX side stays
  at ``num_workers=0``: its stream is the same by construction, each item
  drawn from ``(seed, idx, epoch, attempt)``);
* ``inf_iterator`` across an epoch boundary, and ``skip_epoch`` spending
  the epoch and shuffle that a loader pass abandoned after one batch
  spends (what the JAX training CLI does before it trains).
"""
import os
import threading

import pytest

pytest.importorskip('jax')

from ab_opt_tpu_torch import data as T  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_synthetic_complex)
from ab_opt_tpu_torch.utils.config import load_config  # noqa: E402
from test_torch_data import assert_same  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, BATCH = 7, 3
POOL_TIMEOUT_S = 120


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    """(port, JAX) TransformedDataset over the same preprocessed items."""
    from ab_opt_tpu.data import TransformedDataset as JT
    from ab_opt_tpu.data import get_transform as Jtf
    from ab_opt_tpu.data import preprocess_antibody_structure as Jpre
    root = tmp_path_factory.mktemp('loader')
    cfg, _ = load_config(os.path.join(REPO, 'configs', 'train',
                                      'codesign_single.yml'))
    pipeline = cfg['dataset']['train']['transform']
    tp, jp = [], []
    for i in range(N_ITEMS):
        path = write_synthetic_complex(str(root / f'cx{i}.pdb'), seed=60 + i,
                                       n_antigen=40 + 10 * i)
        task = {'id': f'cx{i}', 'pdb_path': path}
        tp.append(T.preprocess_antibody_structure(dict(task)))
        jp.append(Jpre(dict(task)))
    return (T.TransformedDataset(tp, T.get_transform(pipeline), seed=3),
            JT(jp, Jtf(pipeline), seed=3))


def _loaders(datasets, **kw):
    from ab_opt_tpu.data import DataLoader as JDL
    from ab_opt_tpu.data import PaddingCollate as JPC
    tds, jds = datasets
    return (T.DataLoader(tds, BATCH, collate_fn=T.PaddingCollate(), **kw),
            JDL(jds, BATCH, collate_fn=JPC(), **kw))


@pytest.mark.parametrize('kw', [
    dict(shuffle=True, seed=5), dict(shuffle=False),
    dict(shuffle=True, seed=5, pad_partial=True),
    dict(shuffle=True, seed=9, drop_last=True),
    dict(shuffle=False, prefetch=0, pad_partial=True)],
    ids=['shuffle', 'in_order', 'pad_partial', 'drop_last', 'no_prefetch'])
def test_two_epochs_match_jax(datasets, kw):
    got_loader, want_loader = _loaders(datasets, **kw)
    assert len(got_loader) == len(want_loader)
    for epoch in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for b, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'epoch {epoch} batch {b}')
            full = kw.get('pad_partial') or kw.get('drop_last')
            if full:
                assert g['aa'].shape[0] == BATCH


def _stream(loader, epochs, out):
    for _ in range(epochs):
        out.extend(loader)


def test_worker_pool_stream_equals_inline(datasets):
    tds, _ = datasets
    streams = []
    for workers in (2, 0):
        loader = T.DataLoader(tds, BATCH, collate_fn=T.PaddingCollate(),
                              shuffle=True, seed=11, num_workers=workers,
                              pad_partial=True)
        out = []
        worker = threading.Thread(target=_stream, args=(loader, 2, out),
                                  daemon=True)
        try:
            worker.start()
            worker.join(POOL_TIMEOUT_S)
            assert not worker.is_alive(), (
                f'num_workers={workers}: two epochs took over '
                f'{POOL_TIMEOUT_S} s')
        finally:
            loader.close()
        streams.append(out)
    assert len(streams[0]) == len(streams[1]) == 6
    for b, (g, w) in enumerate(zip(*streams)):
        assert_same(g, w, f'batch {b}')


def test_inf_iterator_and_skip_epoch_match_jax(datasets):
    from ab_opt_tpu.data import inf_iterator as Jinf
    got_loader, want_loader = _loaders(datasets, shuffle=True, seed=2)
    # The JAX CLI's first loader pass, abandoned after one batch.
    next(iter(want_loader))
    got_loader.skip_epoch()
    assert got_loader._epoch == want_loader._epoch == 1
    n = len(got_loader) + 2
    got_it, want_it = T.inf_iterator(got_loader), Jinf(want_loader)
    for b in range(n):
        assert_same(next(got_it), next(want_it), f'batch {b}')
    assert got_loader._epoch == want_loader._epoch == 3
