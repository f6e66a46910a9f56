"""The port's helper modules against the JAX package's on the same numpy
inputs (``nn/plddt.py``, ``nn/tensor_utils.py``, ``nn/inits.py``,
``utils/profiling.py``):

* ``lddt`` (the perfect prediction too), ``compute_plddt`` and
  ``lddt_loss`` at 1e-6;
* ``PerResidueLDDTCaPredictor`` with JAX's weights through
  ``utils/convert.py::per_residue_predictor_state_dict`` at 1e-5;
* ``permute_final_dims``, ``flatten_final_dims`` and ``masked_mean``
  exactly (``masked_mean`` over two axes within one ulp: the libraries
  sum in different orders);
* each initialiser's sample std on a 512 x 512 kernel within 2% of
  flax's (the zeros exactly), and the same generator seed gives the same
  weights;
* ``seed_all`` as ``tests/test_aux.py`` tests JAX's, and ``profile_trace``
  writes a Chrome trace that carries the program's spans and leaves them
  in the span record.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu import nn as JN  # noqa: E402
from ab_opt_tpu.nn import tensor_utils as JT  # noqa: E402
from ab_opt_tpu_torch import nn as TN  # noqa: E402
from ab_opt_tpu_torch.nn import tensor_utils as TT  # noqa: E402
from ab_opt_tpu_torch.utils import profile_trace, recorded, seed_all, span  # noqa: E402

tt = lambda a: torch.from_numpy(np.array(a))


def _structures(seed=0, N=2, L=10):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(N, L, 3)) * 5).astype(np.float32)
    noisy = pos + rng.normal(size=pos.shape).astype(np.float32) * 1.5
    mask = np.ones((N, L, 1), np.float32)
    mask[1, -3:] = 0.0
    return pos, noisy, mask


@pytest.mark.parametrize('perfect', [True, False])
def test_lddt_matches_jax(perfect):
    pos, noisy, mask = _structures()
    pred = pos if perfect else noisy
    want = np.asarray(JN.lddt(jnp.asarray(pred), jnp.asarray(pos),
                              jnp.asarray(mask)))
    got = TN.lddt(tt(pred), tt(pos), tt(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if perfect:
        np.testing.assert_allclose(got, 1.0, atol=1e-5)
    else:
        assert got.mean() < 0.9


def test_plddt_decode_and_loss_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 10, 50)).astype(np.float32)
    pos, noisy, mask = _structures(2)
    np.testing.assert_allclose(TN.compute_plddt(tt(logits)).numpy(),
                               np.asarray(JN.compute_plddt(jnp.asarray(logits))),
                               atol=1e-6 * 100, rtol=0)
    want = float(JN.lddt_loss(jnp.asarray(logits), jnp.asarray(noisy),
                              jnp.asarray(pos), jnp.asarray(mask)))
    lg = tt(logits).requires_grad_()
    p = tt(noisy).requires_grad_()
    got = TN.lddt_loss(lg, p, tt(pos), tt(mask))
    np.testing.assert_allclose(got.item(), want, atol=1e-6, rtol=1e-6)
    got.backward()
    # The target lddt is detached: no gradient reaches the positions.
    assert p.grad is None or float(p.grad.abs().max()) == 0.0
    assert float(lg.grad.abs().max()) > 0


def test_plddt_head_with_jax_weights():
    from ab_opt_tpu_torch.utils.convert import per_residue_predictor_state_dict
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    head = JN.PerResidueLDDTCaPredictor(no_bins=50, c_hidden=16)
    params = head.init(jax.random.key(0), jnp.asarray(x))
    # The final layer initialises to zeros: perturb every weight so that
    # the comparison sees each of them.
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
        .astype(np.float32), params)
    want = np.asarray(head.apply(params, jnp.asarray(x)))
    port = TN.PerResidueLDDTCaPredictor(16, 50, 16)
    port.load_state_dict(per_residue_predictor_state_dict(params))
    with torch.no_grad():
        got = port(tt(x)).numpy()
    assert got.shape == (2, 10, 50)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_tensor_utils_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    for inds in ((2, 0, 1), (1, 0), (0,)):
        np.testing.assert_array_equal(
            TT.permute_final_dims(tt(x), inds).numpy(),
            np.asarray(JT.permute_final_dims(jnp.asarray(x), inds)))
    for n in (1, 2, 3):
        np.testing.assert_array_equal(
            TT.flatten_final_dims(tt(x), n).numpy(),
            np.asarray(JT.flatten_final_dims(jnp.asarray(x), n)))
    m = (rng.random((2, 3, 4, 1)) > 0.4).astype(np.float32)
    for axis in (1, 2):
        np.testing.assert_array_equal(
            TT.masked_mean(tt(m), tt(x), axis).numpy(),
            np.asarray(JT.masked_mean(jnp.asarray(m), jnp.asarray(x), axis)))
    # Over two axes the two libraries sum in different orders: one ulp.
    np.testing.assert_allclose(
        TT.masked_mean(tt(m), tt(x), (1, 2)).numpy(),
        np.asarray(JT.masked_mean(jnp.asarray(m), jnp.asarray(x), (1, 2))),
        rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(
        TT.masked_mean(torch.tensor([[1.0, 1.0, 0.0]]),
                       torch.tensor([[1.0, 2.0, 3.0]]), 1).numpy(), [1.5])


@pytest.mark.parametrize('name', sorted(JN.inits.INIT_BY_NAME))
def test_initialisers_match_flax(name):
    shape = (512, 512)
    want = np.asarray(JN.inits.INIT_BY_NAME[name](jax.random.key(0), shape,
                                                   jnp.float32))
    init = TN.inits.INIT_BY_NAME[name]
    got = init(torch.empty(shape), torch.Generator().manual_seed(0)).numpy()
    again = init(torch.empty(shape), torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(got, again)
    if want.std() == 0:
        np.testing.assert_array_equal(got, want)
        return
    assert abs(got.std() / want.std() - 1) < 0.02, (got.std(), want.std())
    # The truncated normals stop at two of their standard deviations, as
    # flax's do.
    assert np.abs(got).max() <= np.abs(want).max() * 1.05
    assert abs(got.mean()) < 0.02 * want.std()


def test_step_timer_and_seed_all(tmp_path):
    seed_all(7)
    a = np.random.rand()
    seed_all(7)
    assert np.random.rand() == a
    # A span of an earlier session: profile_trace clears the record.
    with torch.profiler.profile():
        with span('earlier'):
            pass
    with profile_trace(str(tmp_path / 'prof')):
        with span('sample.step', t=3):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(tmp_path / 'prof' / 'trace.json'))
    names = [e.get('name', '') for e in trace['traceEvents']]
    assert any('mm' in n for n in names)
    assert 'sample.step' in names
    assert [(s.name, s.attrs) for s in recorded()] == [('sample.step',
                                                        {'t': 3})]
