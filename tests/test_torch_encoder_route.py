"""The sampler's encoder route for a crop longer than the fused GABlock
kernels take (``models/diffab.py::encoder_route``):

* the route on a table of (ipa_impl, device, L, AB_OPT_FUSED_CHAIN):
  ``'auto'`` on the card past 256 takes K4 (the eager GAEncoder over the
  attention kernel with the pair aggregation), ``'pallas_fused'`` past 256
  raises (the JAX package has no fused-layer plan there either), the CPU
  ``'auto'`` route is unchanged;
* that composable encoder at L=320 (2 layers, narrow widths, K4's plain
  version on the CPU, two replicas a complex) sampling 2 steps against the
  JAX sampler (``'einsum'``, JAX's ``'auto'`` off the TPU) on the same
  weights and draws: positions and rotation matrices within 1e-3, codes
  exact, the tolerance of the K4 route's other CPU tests
  (``tests/test_torch_optimize.py``);
* ``DiffAb.sample`` with ``ipa_impl='pallas_fused'`` at L=320 raising.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot  # noqa: E402
from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot  # noqa: E402
from ab_opt_tpu_torch.data.collate import to_device_batch  # noqa: E402
from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig  # noqa: E402
from ab_opt_tpu_torch.models.diffab import encoder_route  # noqa: E402
from ab_opt_tpu_torch.ops import gablock  # noqa: E402
from ab_opt_tpu_torch.ops import ipa_attention as ia  # noqa: E402
from ab_opt_tpu_torch.utils.convert import params_to_state_dict  # noqa: E402
from test_torch_sample import _jax_draws  # noqa: E402

L, LAYERS, STEPS, REPS = 320, 2, 2, 2
KW = dict(res_feat_dim=32, pair_feat_dim=16, num_layers=LAYERS,
          num_steps=STEPS)

# (ipa_impl, on the card, L, chain) -> route; None where it raises.
ROUTES = [
    ('auto', True, 256, False, 'k1'), ('auto', True, 256, True, 'k5'),
    ('auto', True, 320, False, 'k4'), ('auto', True, 320, True, 'k4'),
    ('auto', True, 512, False, 'k4'), ('auto', True, 512, True, 'k4'),
    ('auto', False, 256, False, 'k1'), ('auto', False, 320, False, 'k1'),
    ('auto', False, 320, True, 'k5'), ('auto', False, 512, False, 'k1'),
    ('pallas_fused', True, 256, False, 'k1'),
    ('pallas_fused', True, 256, True, 'k5'),
    ('pallas_fused', False, 256, True, 'k5'),
    ('pallas_fused', True, 320, False, None),
    ('pallas_fused', True, 512, True, None),
    ('pallas_fused', False, 320, False, None),
    ('pallas', True, 256, False, 'k4'), ('pallas', True, 320, True, 'k4'),
    ('pallas', False, 512, False, 'k4'), ('pallas', False, 128, True, 'k4'),
]


@pytest.mark.parametrize('impl,cuda,length,chain,route', ROUTES)
def test_encoder_route(impl, cuda, length, chain, route):
    if route is None:
        with pytest.raises(ValueError, match=r"L up to 256.*'auto'.*'pallas'"):
            encoder_route(impl, cuda, length, chain)
    else:
        assert encoder_route(impl, cuda, length, chain) == route


@pytest.fixture(scope='module')
def models():
    """A JAX DiffAb (einsum, float32) at L=320, 2 layers, 2 steps, flax's
    own init (jitted), its params, and one synthetic complex."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    jmodel = JDiffAb(JConfig(ipa_impl='einsum', **KW))
    jbatch = synthetic_batch(np.random.default_rng(0), N=1, L=L, n_ab=16,
                             gen_lo=6, gen_hi=12)
    params = jax.jit(jmodel.init)(jax.random.key(0), jbatch)
    tbatch = to_device_batch({k: np.array(v) for k, v in jbatch.items()})
    return jmodel, params, jbatch, tbatch


def _port(params, impl):
    model = DiffAb(DiffAbConfig(ipa_impl=impl, **KW))
    model.load_state_dict(params_to_state_dict(params))
    return model


def test_k4_route_at_320_matches_jax(models):
    jmodel, params, jbatch, tbatch = models
    tmodel = _port(params, 'pallas')
    key = jax.random.key(3)
    want = jmodel.sample(params, jbatch, key, num_replicas=REPS)
    gablock.reset_counts()
    ia.reset_counts()
    got = tmodel.sample(tbatch, num_replicas=REPS,
                        draws=_jax_draws(key, REPS, L, STEPS))
    assert ia.ipa_attention_fwd_p2n_reference.calls == STEPS * LAYERS
    assert gablock.gablock_layer_reference.calls == 0
    assert got['p'].shape == (REPS, L, 3)
    np.testing.assert_allclose(got['p'].numpy(), np.asarray(want['p']),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(t_rot(got['v']).numpy(),
                               np.asarray(j_rot(want['v'])), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got['s'].numpy(), np.asarray(want['s']))


def test_pallas_fused_past_256_raises(models):
    _, params, _, tbatch = models
    tmodel = _port(params, 'pallas_fused')
    gablock.reset_counts()
    with pytest.raises(ValueError, match="'pallas_fused' at L=320"):
        tmodel.sample(tbatch, generator=torch.Generator().manual_seed(0))
    assert gablock.gablock_layer_reference.calls == 0
