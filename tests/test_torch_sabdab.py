"""The port's SAbDab and custom datasets (``ab_opt_tpu_torch/data/sabdab.py``,
``custom.py``, the registry) against the JAX package's, on a mini-SAbDab
of synthetic Chothia complexes that the test writes
(``utils/bench_fixture.py::write_mini_sabdab``: two complexes of a test
antigen, one dock-test code, the rest split between val and train).
Everything here is numpy on both sides, so every comparison is exact:

* the filtered summary entries, the preprocessed ids, the CDR clusters and
  every split's ids (train, val, test, dock_test);
* the items of ``configs/train/codesign_single.yml``'s train and val
  transforms through ``get(i, salt)`` for several salts, every field;
* a ``processed_dir`` the JAX package wrote, read by the port (and one the
  port wrote, read by the JAX package);
* ``greedy_cluster`` on a table of sequences; the loader's DISTVIOLATION
  neighbour hop; ``CustomDataset``.
"""
import os
import shutil

import numpy as np
import pytest

pytest.importorskip('jax')

from ab_opt_tpu_torch import data as T  # noqa: E402
from ab_opt_tpu_torch.data import loader as TL  # noqa: E402
from ab_opt_tpu_torch.data import sabdab as TS  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_mini_sabdab, write_synthetic_complex)
from ab_opt_tpu_torch.utils.config import load_config  # noqa: E402
from test_torch_data import assert_same  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COMPLEXES = 26          # 2 test, 1 dock-test, 20 val, 3 train
SPLITS = ('train', 'val', 'test', 'dock_test')
SALTS = ((0, 0), (1, 0), (3, 2))


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The mini-SAbDab, with a processed_dir written by each package."""
    from ab_opt_tpu.data.sabdab import SAbDabDataset as J
    root = tmp_path_factory.mktemp('sabdab')
    paths = write_mini_sabdab(str(root), n=N_COMPLEXES)
    common = dict(summary_path=paths['summary_path'],
                  chothia_dir=paths['chothia_dir'], num_workers=2)
    J(processed_dir=str(root / 'jax'), **common)
    TS.SAbDabDataset(processed_dir=str(root / 'port'), **common)
    return root, paths


def _cfg(paths, split, processed, which='train'):
    cfg, _ = load_config(os.path.join(REPO, 'configs', 'train',
                                      'codesign_single.yml'))
    return dict(cfg['dataset'][which], **dict(paths, processed_dir=processed),
                split=split)


def test_entries_match_jax(mini):
    from ab_opt_tpu.data.sabdab import load_sabdab_entries as J
    _, paths = mini
    got, want = (TS.load_sabdab_entries(paths['summary_path']),
                 J(paths['summary_path']))
    assert len(got) == N_COMPLEXES
    assert got == want


@pytest.mark.parametrize('split', SPLITS)
def test_splits_match_jax(mini, split):
    from ab_opt_tpu.data.sabdab import SAbDabDataset as J
    root, paths = mini
    common = dict(summary_path=paths['summary_path'],
                  chothia_dir=paths['chothia_dir'], split=split)
    got = TS.SAbDabDataset(processed_dir=str(root / 'port'), **common)
    want = J(processed_dir=str(root / 'jax'), **common)
    assert got.db_ids == want.db_ids
    assert got.sabdab_entries == want.sabdab_entries
    assert got.id_to_cluster == want.id_to_cluster
    assert got.clusters == want.clusters
    assert got.ids_in_split == want.ids_in_split
    sizes = {'test': 2, 'dock_test': 1, 'val': 20,
             'train': N_COMPLEXES - 23}
    assert len(got) == sizes[split]
    if split == 'dock_test':
        assert got.ids_in_split == ['5mes_H_L_A']


@pytest.mark.parametrize('which', ['train', 'val'])
def test_items_match_jax(mini, which):
    """codesign_single's transforms through get(i, salt), every field."""
    from ab_opt_tpu.data import get_dataset as J
    root, paths = mini
    got = T.get_dataset(_cfg(paths, which, str(root / 'port'), which))
    want = J(_cfg(paths, which, str(root / 'jax'), which))
    assert len(got) == len(want)
    for i in range(0, len(got), 3):
        for salt in SALTS:
            item = got.get(i, salt)
            assert_same(item, want.get(i, salt), f'{which}[{i}] {salt}')
            assert item['generate_flag'].any()


def test_jax_processed_dir_loads_in_the_port(mini):
    """Each package reads the other's cache: the same structures."""
    from ab_opt_tpu.data.sabdab import SAbDabDataset as J
    root, paths = mini
    common = dict(summary_path=paths['summary_path'],
                  chothia_dir=paths['chothia_dir'], split='val')
    port_on_jax = TS.SAbDabDataset(processed_dir=str(root / 'jax'), **common)
    port_on_port = TS.SAbDabDataset(processed_dir=str(root / 'port'), **common)
    jax_on_port = J(processed_dir=str(root / 'port'), **common)
    assert port_on_jax.ids_in_split == port_on_port.ids_in_split
    for sid in port_on_jax.db_ids:
        want = port_on_port.get_structure(sid)
        assert_same(port_on_jax.get_structure(sid), want, sid)
        assert_same(jax_on_port.get_structure(sid), want, sid)


def test_greedy_cluster_matches_jax():
    from ab_opt_tpu.data.sabdab import greedy_cluster as J
    rng = np.random.default_rng(0)
    alpha = np.array(list('ACDEFGHIKLMNPQRSTVWY'))
    seqs = {}
    for fam in range(4):
        base = rng.choice(alpha, size=int(rng.integers(6, 16)))
        for k in range(5):
            s = base.copy()
            hit = rng.choice(len(s), size=int(rng.integers(0, 5)),
                             replace=False)
            s[hit] = rng.choice(alpha, size=len(hit))
            seqs[f'f{fam}_{k}'] = ''.join(s)
    seqs['short'] = 'AR'
    for min_identity in (0.3, 0.5, 0.8):
        got = TS.greedy_cluster(seqs, min_identity)
        assert got == J(seqs, min_identity)
        assert set(got) == set(seqs)
    assert TS.greedy_cluster({'a': 'ARDY', 'b': 'ARDY'}) == {'a': 'a',
                                                             'b': 'a'}


class _Violating:
    """Items 0..n-1; ``get`` raises ``exc`` for the indices in ``bad`` on
    every attempt but the last few, so the hop and the retries both show."""

    def __init__(self, n, bad, exc):
        self.n, self.bad, self.exc = n, set(bad), exc

    def __len__(self):
        return self.n

    def get(self, idx, salt=(0, 0)):
        if idx in self.bad and salt[1] < 5:
            raise self.exc('violation')
        return {'idx': idx, 'salt': tuple(salt)}


def test_distviolation_hop_matches_jax():
    from ab_opt_tpu.data import DISTVIOLATION as JV
    from ab_opt_tpu.data.loader import _fetch_with_resample as J
    bad = (0, 1, 2, 5, 6, 7, 8, 11, 12, 13, 17)
    tds, jds = _Violating(20, bad, T.DISTVIOLATION), _Violating(20, bad, JV)
    hops = 0
    for seed in (0, 7):
        for epoch in (0, 1, 4):
            for idx in range(20):
                got = TL._fetch_with_resample(tds, idx, epoch, seed)
                assert got == J(jds, idx, epoch, seed)
                hops += got['idx'] != idx
    assert hops > 0
    always = _Violating(4, range(4), T.DISTVIOLATION)
    with pytest.raises(RuntimeError, match='Too many consecutive'):
        TL._fetch_with_resample(always, 0, 0, 0, max_retries=5)


def test_custom_dataset_matches_jax(tmp_path):
    from ab_opt_tpu.data import get_dataset as J
    for name in ('jax', 'port'):
        os.makedirs(tmp_path / name)
        for i in range(3):
            write_synthetic_complex(str(tmp_path / name / f'cx{i}.pdb'),
                                    seed=40 + i)
    transform = [{'type': 'mask_single_cdr'}, {'type': 'merge_chains'},
                 {'type': 'patch_around_anchor', 'initial_patch_size': 32,
                  'antigen_size': 16}]
    got = T.get_dataset({'type': 'custom', 'structure_dir':
                         str(tmp_path / 'port'), 'transform': transform})
    want = J({'type': 'custom', 'structure_dir': str(tmp_path / 'jax'),
              'transform': transform})
    assert isinstance(got, T.CustomDataset)
    assert got.ids == want.ids == ['cx0.pdb', 'cx1.pdb', 'cx2.pdb']
    for i in range(3):
        for salt in SALTS:
            assert_same(got.get(i, salt), want.get(i, salt), f'{i} {salt}')
    # The cache the port wrote is read as it is.
    shutil.rmtree(tmp_path / 'jax')
    again = T.CustomDataset(str(tmp_path / 'port'))
    assert again.ids == got.ids
