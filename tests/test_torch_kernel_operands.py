"""The operands the sampler hands K1 and K5 for a float32 config.

As the JAX package builds them for its kernel route, the weight bundles,
``z`` and the per-layer pair biases are bf16 whatever the compute dtype,
whenever the kernel route is taken: on a CUDA device, or with
``ipa_impl='pallas_fused'`` on any device. ``'auto'`` on the CPU stays in
the compute dtype (JAX's einsum off the accelerator), so the float32
``'auto'`` port keeps its float32 tests against JAX ``'einsum'``.

* a float32 ``'pallas_fused'`` DiffAb (L=32, 2 layers, 2 steps, fan-out 2)
  against JAX ``DiffAbConfig(ipa_impl='pallas_fused')`` at float32, its
  kernel in interpret mode, same weights (through the weight bridge) and
  the same draws: every step's positions and rotation matrices within the
  bf16 budget 0.03, sequences exact;
* the dtypes and shapes ``prepare_denoiser`` hands the K1 and K5 wrappers
  (spies in their place) against the table the kernels check
  (``ops.gablock._expected``), for float32 and bfloat16 configs.
The same denoiser through K1 and K5 on the card: tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.geometry import rotation_to_so3vec  # noqa: E402
from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig  # noqa: E402
from ab_opt_tpu_torch.ops import gablock as gb  # noqa: E402

L, REPS, STEPS = 32, 2, 2
KW = dict(res_feat_dim=32, pair_feat_dim=16, num_layers=2, num_steps=STEPS)
BUDGET = 0.03


@pytest.fixture(scope='module')
def models():
    """The port DiffAb (float32, 'pallas_fused', seeded torch init), the JAX
    DiffAb of the same config carrying its weights, one synthetic complex
    at L=32."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    from ab_opt_tpu.utils.torch_convert import convert_diffab_state_dict
    from ab_opt_tpu_torch.data.collate import to_device_batch
    torch.manual_seed(0)
    tmodel = DiffAb(DiffAbConfig(ipa_impl='pallas_fused', **KW))
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_diffab_state_dict(tmodel.state_dict(), 2))
    jmodel = JDiffAb(JConfig(ipa_impl='pallas_fused', **KW))
    assert jmodel.cfg.dtype == 'float32' and tmodel.cfg.dtype == 'float32'
    jbatch = synthetic_batch(np.random.default_rng(0), N=1, L=L, n_ab=20,
                             gen_lo=8, gen_hi=16)
    tbatch = to_device_batch({k: np.array(v) for k, v in jbatch.items()})
    return jmodel, params, jbatch, tmodel, tbatch


def test_float32_pallas_fused_sample_matches_jax_interpret(models):
    from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot
    from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot
    from test_torch_sample import _jax_draws
    jmodel, params, jbatch, tmodel, tbatch = models
    key = jax.random.key(3)
    want = jmodel.sample(params, jbatch, key, num_replicas=REPS,
                         keep_traj=True)['traj']
    gb.reset_counts()
    with torch.no_grad():
        got = tmodel.sample(tbatch, num_replicas=REPS, keep_traj=True,
                            draws=_jax_draws(key, REPS, L, STEPS))['traj']
    assert gb.gablock_layer_reference.calls == STEPS * KW['num_layers']
    for i in range(STEPS):
        np.testing.assert_allclose(got['p'][i].numpy(),
                                   np.asarray(want['p'][i]), atol=BUDGET,
                                   rtol=0)
        np.testing.assert_allclose(t_rot(got['v'][i]).numpy(),
                                   np.asarray(j_rot(want['v'][i])),
                                   atol=BUDGET, rtol=0)
        np.testing.assert_array_equal(got['s'][i].numpy(),
                                      np.asarray(want['s'][i]))


@pytest.fixture(scope='module')
def full_width_batch():
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    return synthetic_batch(np.random.default_rng(1), N=1, L=L, n_ab=20,
                           gen_lo=8, gen_hi=16)


def _spy_operands(model, batch, reps, chain_env, monkeypatch):
    """One denoiser evaluation with spies for the K1 and K5 wrappers (each
    records its operands, then runs the plain version); returns the
    records."""
    if chain_env:
        monkeypatch.setenv('AB_OPT_FUSED_CHAIN', '1')
    else:
        monkeypatch.delenv('AB_OPT_FUSED_CHAIN', raising=False)
    seen = []

    def layer(x, R9, t, z, bias, mask, wb, r):
        seen.append(('layer', (x, R9, t, z, bias, mask, wb, r)))
        return gb.gablock_layer_reference(x, R9, t, z, bias, mask, wb, r)

    def chain(stacked, nl, R9, t, x, z, biases, mask, r):
        seen.append(('chain', (stacked, nl, R9, t, x, z, biases, mask, r)))
        return gb.fused_encoder_chained_reference(stacked, nl, R9, t, x, z,
                                                  biases, mask, r)

    rep = lambda a: a.repeat_interleave(reps, 0)
    with torch.no_grad():
        res_feat, pair_feat, R0, p0 = model.encode(batch, True, True)
        gen, mres = rep(batch['generate_flag']), rep(batch['mask'])
        enc, hw = model.prepare_denoiser(pair_feat, mres, reps, layer=layer,
                                         chain=chain)
        out = model.eps_net(rotation_to_so3vec(rep(R0)),
                            model.normalize_position(rep(p0)),
                            rep(batch['aa']), rep(res_feat), pair_feat,
                            torch.full((reps,), 0.1), gen, mres, reps=reps,
                            encoder_fn=enc, head_weights=hw)
    assert all(torch.isfinite(o).all() for o in out)
    dt = model.cfg.compute_dtype
    assert all(w.dtype == dt for w in hw.values() if torch.is_tensor(w)
               and w.is_floating_point())
    return seen


def _assert_kernel_dtypes(expect, extra):
    for name, (a, shape, dtype) in {**expect, **extra}.items():
        assert a.dtype == dtype, (name, a.dtype, dtype)
        assert tuple(a.shape) == tuple(shape), (name, a.shape, shape)


@pytest.mark.parametrize('chain_env', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_kernel_route_hands_the_kernels_bf16(full_width_batch, monkeypatch,
                                             dtype, chain_env):
    """'pallas_fused' on the CPU takes the kernel route: K1's (or K5's)
    operands are those the kernel checks (full widths: node 128, pair 64,
    12 heads; 2 layers), bf16 bundles, z and biases, for a float32 config
    as for a bfloat16 one."""
    torch.manual_seed(0)
    model = DiffAb(DiffAbConfig(ipa_impl='pallas_fused', dtype=dtype,
                                num_layers=2, num_steps=STEPS))
    seen = _spy_operands(model, full_width_batch, REPS, chain_env,
                         monkeypatch)
    layers = 2
    assert [k for k, _ in seen] == (['chain'] if chain_env
                                    else ['layer'] * layers)
    bf16 = torch.bfloat16
    for kind, args in seen:
        if kind == 'layer':
            x, R9, t, z, bias, mask, wb, r = args
            expect = gb._expected(x, R9, t, z, mask, wb, r)
            H = wb['dims'][0]
            extra = {'bias': (bias, (x.shape[0] // r, H, L, L), bf16)}
            extra.update({n + '_t': (wb[n + '_t'], wb[n].shape[::-1], bf16)
                          for n in gb.TRANSPOSED})
        else:
            stacked, nl, R9, t, x, z, biases, mask, r = args
            expect = gb._expected(x, R9, t, z, mask, stacked, r, (nl,))
            H = stacked['dims'][0]
            extra = {'biases': (biases, (x.shape[0] // r, nl, H, L, L),
                                bf16)}
        _assert_kernel_dtypes(expect, extra)


def test_cpu_auto_route_keeps_the_compute_dtype(models, monkeypatch):
    """'auto' on the CPU is JAX's einsum route: float32 operands, the
    per-layer plain version in float32 (the float32 tests against JAX
    'einsum' hold at their tolerances)."""
    torch.manual_seed(0)
    model = DiffAb(dataclasses.replace(models[3].cfg, ipa_impl='auto'))
    for chain_env in (False, True):
        seen = _spy_operands(model, models[4], REPS, chain_env, monkeypatch)
        for kind, args in seen:
            z = args[3] if kind == 'layer' else args[5]
            weights = args[6] if kind == 'layer' else args[0]
            bias = args[4] if kind == 'layer' else args[6]
            assert z.dtype == bias.dtype == torch.float32
            assert weights['w_proj'].dtype == torch.float32
