"""The port's DockQ (``tools/dockq``) against the JAX package's, on
model/native pairs the test writes from a synthetic Chothia complex: the
native is the antigen plus the antibody patch around CDR-H3, as the design
runner saves it; the models move CDR-H3, shift the heavy chain, mutate
residues, drop residues or renumber a chain (the alignment path). Every
score within 1e-6 of JAX's, on the port's native contact kernel (its own
``fnat_kernel.cc``, built with g++ at first use) and on the numpy contact
path (JAX's numpy path forced the same way)."""
import copy

import numpy as np
import pytest

pytest.importorskip('jax')

from ab_opt_tpu_torch.data import (  # noqa: E402
    mask_select_data, preprocess_antibody_structure, save_pdb)
from ab_opt_tpu_torch.runners.design import create_data_variants  # noqa: E402
from ab_opt_tpu_torch.tools.dockq import dockq as TQ  # noqa: E402
from ab_opt_tpu_torch.utils.bench_fixture import (  # noqa: E402
    write_synthetic_complex)

KEYS = ('DockQ', 'irms', 'Lrms', 'fnat', 'fnonnat', 'nat_correct',
        'nat_total', 'nonnat_count', 'model_total')


def _move_h3(d, rng):
    d['pos_heavyatom'] = d['pos_heavyatom'].copy()
    gen = d['generate_flag']
    d['pos_heavyatom'][gen] += rng.normal(size=(gen.sum(), 1, 3)) * 2.0
    return d


def _shift_heavy(d, rng):
    d['pos_heavyatom'] = d['pos_heavyatom'].copy()
    heavy = d['fragment_type'] == 1
    d['pos_heavyatom'][heavy] += np.array([1.5, -2.0, 0.7], np.float32)
    return d


def _mutate(d, rng):
    d['aa'] = d['aa'].copy()
    gen = np.flatnonzero(d['generate_flag'])
    d['aa'][gen] = rng.integers(0, 20, len(gen))
    return _move_h3(d, rng)


def _drop(d, rng):
    keep = np.ones(len(d['aa']), bool)
    keep[rng.choice(len(keep), 6, replace=False)] = False
    return mask_select_data(_move_h3(d, rng), keep)


def _renumber(d, rng):
    d['resseq'] = np.where(d['fragment_type'] == 3, d['resseq'] + 7,
                           d['resseq'])
    return _move_h3(d, rng)


CASES = {'native': lambda d, rng: d, 'move_h3': _move_h3,
         'shift_heavy': _shift_heavy, 'mutate': _mutate, 'drop': _drop,
         'renumber': _renumber}


@pytest.fixture(scope='module')
def pairs(tmp_path_factory):
    """{case: (model text, native text)}."""
    root = tmp_path_factory.mktemp('dockq')
    pdb = write_synthetic_complex(str(root / 'cx.pdb'), seed=1)
    s = preprocess_antibody_structure({'id': 'cx', 'pdb_path': pdb})
    data = create_data_variants('single_cdr', {'cdrs': ['H_CDR3']}, s,
                                np.random.default_rng(0))[0]['data']
    ag = data['fragment_type'] == 3
    ca = data['pos_heavyatom'][:, 1]
    gen_ca = ca[data['generate_flag']]
    near = np.linalg.norm(ca[:, None] - gen_ca[None], axis=-1).min(1) < 25.0
    native = mask_select_data(data, ag | near)
    out = {}
    for i, (name, fn) in enumerate(CASES.items()):
        model = fn(copy.deepcopy(native), np.random.default_rng(i))
        out[name] = (save_pdb(model), save_pdb(native))
    return out


@pytest.mark.parametrize('ca_only', [True, False])
@pytest.mark.parametrize('contacts', ['native', 'numpy'])
@pytest.mark.parametrize('case', list(CASES))
def test_calc_dockq_matches_jax(pairs, monkeypatch, case, contacts, ca_only):
    from ab_opt_tpu.tools.dockq import dockq as JQ
    native = contacts == 'native'
    if native:
        assert TQ.native_library() is not None
    else:   # each package's numpy contact path
        monkeypatch.setattr(JQ, '_lib', False)
        monkeypatch.setattr(TQ, '_lib', False)
    model, ref = pairs[case]
    before = TQ._contacts.native_calls
    got = TQ.calc_dockq(model, ref, use_ca_only=ca_only)
    assert TQ._contacts.native_calls - before == (3 if native else 0)
    want = JQ.calc_dockq(model, ref, use_ca_only=ca_only)
    assert sorted(got) == sorted(want)
    for k in KEYS:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    if case == 'native':
        assert got['DockQ'] == pytest.approx(1.0) and got['fnat'] == 1.0
    assert got['nat_total'] > 0
    assert TQ.capri_class(got['DockQ']) == JQ.capri_class(want['DockQ'])


def test_native_and_numpy_contacts_agree(pairs):
    """The kernel against its plain version on the same atoms."""
    from ab_opt_tpu_torch.data import parse_pdb
    model, _ = pairs['move_h3']
    d, _ = parse_pdb(model, is_text=True)
    cx = TQ._Complex(d, TQ._chain_groups(d['chain_id']))
    a, b = cx.atom_arrays(0), cx.atom_arrays(1)
    for cutoff in (5.0, 10.0):
        got = TQ._contacts(*a, *b, cutoff)
        want = TQ._contacts_numpy(*a, *b, cutoff)
        assert got == want and len(got) > 0


def test_kabsch_and_plain_rmsd_match_jax():
    from ab_opt_tpu.tools.dockq import kabsch_rmsd, plain_rmsd
    rng = np.random.default_rng(0)
    P = rng.normal(size=(20, 3))
    Q = P @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 3.0
    Q += rng.normal(size=Q.shape) * 0.1
    extra = rng.normal(size=(5, 3))
    for kw in ({}, {'apply_to': extra}):
        got, want = TQ.kabsch_rmsd(P, Q, **kw), kabsch_rmsd(P, Q, **kw)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    assert TQ.plain_rmsd(P, Q) == plain_rmsd(P, Q)


def test_native_library_is_built_from_the_ports_source():
    lib = TQ.native_library()
    assert lib is not None
    assert TQ.library_path().exists()
    assert TQ.library_path().parent.name == '_build'
    assert TQ._SRC_PATH.parent.name == 'dockq'
    assert 'ab_opt_tpu_torch' in str(TQ._SRC_PATH)
