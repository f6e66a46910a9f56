"""The port's host data layer, config loader and metrics against the JAX
package's, on a synthetic Chothia complex (heavy H, light L, antigen A)
that the test writes: everything here is numpy on both sides, so every
comparison is exact (arrays bitwise, lists and strings equal):

* ``parse_pdb`` (with chain selection and ``max_resseq``),
  ``pdb_chain_ids`` and ``preprocess_antibody_structure``;
* every transform pipeline under ``configs/`` (each YAML's dataset
  ``transform`` lists), the transforms the design runner builds (the
  inference crop with and without the native removal, the property
  labels, the hotspot crop) and ``create_data_variants`` in all five
  modes, from the same ``numpy.random.default_rng`` seed;
* ``PaddingCollate`` (the runner's buckets and the default ones) and
  ``apply_patch_to_tensor``;
* ``load_config`` on every YAML under ``configs/``;
* the ``metrics`` functions;
* a parse -> save -> parse round trip.
"""
import copy
import glob
import os

import numpy as np
import pytest

pytest.importorskip('jax')

from ab_opt_tpu_torch import data as T  # noqa: E402
from ab_opt_tpu_torch import metrics as TM  # noqa: E402
from ab_opt_tpu_torch.runners import design as TD  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_synthetic_complex)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, 'configs', '**', '*.yml'),
                         recursive=True))
MODES = {'single_cdr': {'cdrs': ['H_CDR3', 'L_CDR1']},
         'multiple_cdrs': {'cdrs': ['H_CDR1', 'H_CDR3', 'L_CDR3']},
         'dock_antibody': {'antibody_chains': ['heavy', 'light']},
         'full': {},
         'abopt': {'cdrs': ['H_CDR3'], 'optimize_steps': [4, 8]}}


def assert_same(got, want, path='data'):
    """Equal structure; arrays bitwise with the same dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f'{path}[{k!r}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{path}[{i}]')
    else:
        assert got == want or (got is None and want is None), (path, got, want)


@pytest.fixture(scope='module')
def pdb(tmp_path_factory):
    return write_synthetic_complex(
        str(tmp_path_factory.mktemp('cx') / 'cx.pdb'), seed=3)


@pytest.fixture(scope='module')
def structures(pdb):
    from ab_opt_tpu.data import preprocess_antibody_structure as J
    task = {'id': 'cx', 'pdb_path': pdb, 'heavy_id': 'H', 'light_id': 'L'}
    return T.preprocess_antibody_structure(dict(task)), J(dict(task))


@pytest.mark.parametrize('kw', [
    {}, {'chain_ids': ['H'], 'max_resseq': 113},
    {'chain_ids': ['L'], 'max_resseq': 106}, {'chain_ids': ['A', 'H']}])
def test_parse_pdb_matches_jax(pdb, kw):
    from ab_opt_tpu.data import parse_pdb as J
    got, want = T.parse_pdb(pdb, **kw), J(pdb, **kw)
    assert_same(got[0], want[0])
    assert got[1] == want[1]


def test_pdb_chain_ids_and_text_parse_match_jax(pdb):
    from ab_opt_tpu.data import parse_pdb as J
    from ab_opt_tpu.data import pdb_chain_ids as Jids
    assert T.pdb_chain_ids(pdb) == Jids(pdb) == ['A', 'H', 'L']
    text = open(pdb).read()
    assert_same(T.parse_pdb(text, is_text=True)[0],
                J(text, is_text=True)[0])


@pytest.mark.parametrize('whole_heavy', [False, True])
def test_preprocess_antibody_structure_matches_jax(pdb, whole_heavy):
    from ab_opt_tpu.data import preprocess_antibody_structure as J
    task = {'id': 'cx', 'pdb_path': pdb}
    kw = dict(label_whole_heavy_chain_as_cdr=whole_heavy)
    got, want = (T.preprocess_antibody_structure(dict(task), **kw),
                 J(dict(task), **kw))
    assert want is not None
    assert_same(got, want)
    heavy = ['H_CDR3'] if whole_heavy else ['H_CDR1', 'H_CDR2', 'H_CDR3']
    assert TD.find_cdrs(got) == heavy + ['L_CDR1', 'L_CDR2', 'L_CDR3']


def _config_pipelines():
    """(name, transform list) of every dataset split under configs/."""
    from ab_opt_tpu_torch.utils.config import load_config
    out = []
    for path in YAMLS:
        cfg, name = load_config(path)
        for split, ds in (cfg.get('dataset') or {}).items():
            if isinstance(ds, dict) and ds.get('transform'):
                out.append((f'{name}:{split}', ds['transform']))
    assert len(out) >= 10
    return out


_PIPELINES = _config_pipelines()


@pytest.mark.parametrize('name,pipeline', _PIPELINES,
                         ids=[n for n, _ in _PIPELINES])
def test_config_transform_pipelines_match_jax(structures, name, pipeline):
    """Each split's pipeline on the structure, three draws of one seed."""
    from ab_opt_tpu.data import get_transform as J
    tp, jp = T.get_transform(pipeline), J(pipeline)
    rt, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        outs = []
        for fn, s, r in ((tp, structures[0], rt), (jp, structures[1], rj)):
            try:
                outs.append(fn(copy.deepcopy(s), rng=r))
            except Exception as e:   # the same refusal on both sides
                outs.append((type(e).__name__, str(e)))
        assert_same(outs[0], outs[1], name)


RUNNER_STEPS = [
    [{'type': 'patch_around_anchor', 'initial_patch_size': 128,
      'antigen_size': 128, 'remove_anchor': False},
     {'type': 'remove_native', 'remove_structure': True,
      'remove_sequence': True}],
    [{'type': 'patch_around_anchor', 'initial_patch_size': 0,
      'antigen_size': 20, 'remove_anchor': True},
     {'type': 'remove_native', 'remove_structure': True,
      'remove_sequence': False}],
    [{'type': 'patch_around_anchor', 'initial_patch_size': 128,
      'antigen_size': 128, 'remove_anchor': False}],
    [{'type': 'patch_around_anchor_hotspot', 'initial_patch_size': 60,
      'antigen_size': 60, 'max_nb_hotspots': 3},
     {'type': 'aa_label', 'hydropathy': True, 'charge': True,
      'drop_prob': 0.3},
     {'type': 'select_atom', 'resolution': 'backbone'}],
]


@pytest.mark.parametrize('mode', list(MODES))
def test_create_data_variants_match_jax(structures, mode):
    from ab_opt_tpu.runners.design import create_data_variants as J
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    got = TD.create_data_variants(mode, MODES[mode], structures[0], rt)
    want = J(mode, MODES[mode], structures[1], rj)
    assert len(got) >= 1
    assert_same(got, want)
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize('steps', range(len(RUNNER_STEPS)))
@pytest.mark.parametrize('mode', ['single_cdr', 'full'])
def test_inference_crop_and_collate_match_jax(structures, mode, steps):
    """The runner's crops of each variant, collated into the runner's
    buckets and the default ones, and pasted back."""
    from ab_opt_tpu.data import get_transform as J
    from ab_opt_tpu.data.collate import PaddingCollate as JCollate
    from ab_opt_tpu.data.collate import apply_patch_to_tensor as JPaste
    from ab_opt_tpu.runners.design import create_data_variants as JV
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    tv = TD.create_data_variants(mode, MODES[mode], structures[0], rt)
    jv = JV(mode, MODES[mode], structures[1], rj)
    tf, jf = T.get_transform(RUNNER_STEPS[steps]), J(RUNNER_STEPS[steps])
    for a, b in zip(tv, jv):
        got = tf(copy.deepcopy(a['data']), rng=rt)
        want = jf(copy.deepcopy(b['data']), rng=rj)
        assert_same(got, want)
        for buckets in (TD.LENGTH_BUCKETS, None):
            kw = {} if buckets is None else {'buckets': buckets}
            assert_same(T.PaddingCollate(**kw)([got, got]),
                        JCollate(**kw)([want, want]))
        if 'patch_idx' in got:
            pos = got['pos_heavyatom'] + 1.5
            assert_same(
                T.apply_patch_to_tensor(a['data']['pos_heavyatom'], pos,
                                        got['patch_idx']),
                JPaste(b['data']['pos_heavyatom'], pos, want['patch_idx']))


def test_runner_crop_fills_the_buckets(structures):
    """codesign_single's crop of the synthetic complex fills the 256 bucket
    and dock_cdr's the 32 one (the sizes the card's design phase runs)."""
    lengths = []
    for steps in RUNNER_STEPS[:2]:
        v = TD.create_data_variants('single_cdr', {'cdrs': ['H_CDR3']},
                                    structures[0], np.random.default_rng(0))
        crop = T.get_transform(steps)(copy.deepcopy(v[0]['data']),
                                      rng=np.random.default_rng(0))
        lengths.append(T.PaddingCollate(buckets=TD.LENGTH_BUCKETS)(
            [crop])['aa'].shape[1])
    assert lengths == [256, 32]


@pytest.mark.parametrize('path', YAMLS,
                         ids=[os.path.relpath(p, REPO) for p in YAMLS])
def test_load_config_matches_jax(path):
    from ab_opt_tpu.utils.config import load_config as J
    from ab_opt_tpu_torch.utils.config import ConfigDict, load_config
    got, want = load_config(path), J(path)
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert isinstance(got[0], ConfigDict) and isinstance(
        got[0].get('model', {}), dict)
    if 'model' in got[0]:
        assert got[0].model == want[0].model


def test_metrics_match_jax():
    from ab_opt_tpu import metrics as JM
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 20, 30), rng.integers(0, 20, 30)
    assert TM.amino_acid_recovery(a, b) == JM.amino_acid_recovery(a, b)
    assert np.isnan(TM.amino_acid_recovery([], []))
    p, q = rng.normal(size=(12, 3)), rng.normal(size=(12, 3))
    assert TM.ca_rmsd(p, q) == JM.ca_rmsd(p, q)
    s = rng.normal(size=(9, 21, 3)).astype(np.float32)
    np.testing.assert_array_equal(TM.pairwise_structure_rmsd(s),
                                  JM.pairwise_structure_rmsd(s))
    for k in (1, 4, 9):
        np.testing.assert_array_equal(TM.rank_commonness(s, k),
                                      JM.rank_commonness(s, k))
    assert TM.average_pairwise_rmsd(s) == JM.average_pairwise_rmsd(s)
    np.testing.assert_array_equal(TM.BLOSUM62, JM.BLOSUM62)
    for n, m in ((17, 17), (20, 14), (5, 11), (0, 4)):
        x, y = rng.integers(0, 20, n), rng.integers(0, 20, m)
        y[:min(n, m) // 2] = x[:min(n, m) // 2]
        assert TM.global_align_pairs(x, y) == JM.global_align_pairs(x, y)
        assert (TM.global_align_identity(x, y)
                == JM.global_align_identity(x, y))


def test_parse_save_parse_round_trip(pdb, tmp_path):
    first, _ = T.parse_pdb(pdb)
    text = T.save_pdb(first, str(tmp_path / 'again.pdb'))
    assert text == open(tmp_path / 'again.pdb').read()
    second, _ = T.parse_pdb(str(tmp_path / 'again.pdb'))
    assert_same(second, first)
    assert T.save_pdb(second) == text


def test_save_pdb_matches_jax_on_a_crop(structures):
    from ab_opt_tpu.data import save_pdb as J
    v = TD.create_data_variants('single_cdr', {'cdrs': ['H_CDR3']},
                                structures[0], np.random.default_rng(0))
    crop = T.get_transform(RUNNER_STEPS[0])(copy.deepcopy(v[0]['data']),
                                           rng=np.random.default_rng(0))
    assert T.save_pdb(crop) == J(crop)
    sub = T.mask_select_data(v[0]['data'], v[0]['data']['fragment_type'] != 2)
    assert T.save_pdb(sub) == J(sub)


def test_contig_and_registry_match_jax():
    from ab_opt_tpu.data import generate_mask_from_contig as J
    from ab_opt_tpu.data.transforms import _TRANSFORM_DICT as JT
    from ab_opt_tpu_torch.data.transforms import _TRANSFORM_DICT
    assert sorted(_TRANSFORM_DICT) == sorted(JT)
    for contig, n in (('1-3', 8), ('2-8', 8), ('4-4', 5)):
        np.testing.assert_array_equal(T.generate_mask_from_contig(contig, n),
                                      J(contig, n))
