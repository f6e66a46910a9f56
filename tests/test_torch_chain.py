"""The chained whole-encoder sampler (K5) of the port against the JAX
package, on the CPU, inputs made from a numpy seed:

* the plain chain (``ops.gablock.fused_encoder_chained_reference``) in bf16
  against JAX ``fused_encoder_chained`` (interpret mode, base body
  ``body_opts=None``) over two GABlocks with distinct weights: atol/rtol
  0.05 on valid rows, the budget of tests/test_ipa_pallas.py:230;
* the same plain chain in f32 against two applications of the JAX GABlock
  module (einsum, f32): atol 1e-4;
* ``DiffAb`` in f32 with ``AB_OPT_FUSED_CHAIN=1``: every reverse step
  against JAX's trajectory from the same draws (positions and rotation
  matrices at 1e-3, codes exact), one chained call a step and no per-layer
  call; and where the chain is not taken (the variable unset or '0', one
  layer, ``ipa_impl='pallas'``);
* the wrapper: CPU tensors take the plain version; anything else launches
  the kernel or raises, and never falls back.
The kernel itself is held against the plain chain and against K1 on a card
in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.nn.ipa import GABlock, precompute_pair_bias  # noqa: E402
from ab_opt_tpu_torch.ops import gablock as gb  # noqa: E402
from ab_opt_tpu_torch.utils.convert import ga_block_state_dict  # noqa: E402
from test_torch_gablock import _perturb  # noqa: E402

LAYERS = 2
tt = torch.from_numpy


def _chain_case(Nc, reps, n_pad, seed, L=16, F=32, Cz=16, H=4):
    """Inputs (numpy), LAYERS JAX GABlocks with distinct perturbed params
    and the matching port blocks."""
    from ab_opt_tpu.geometry import quaternion_to_rotation_matrix
    from ab_opt_tpu.nn.ipa import GABlock as JBlock
    rng = np.random.default_rng(seed)
    N = Nc * reps
    q = rng.normal(size=(N, L, 4)).astype(np.float32)
    R = np.array(quaternion_to_rotation_matrix(jnp.asarray(q)))
    t = rng.normal(size=(N, L, 3)).astype(np.float32)
    x = rng.normal(size=(N, L, F)).astype(np.float32)
    z = rng.normal(size=(Nc, L, L, Cz)).astype(np.float32)
    mask_c = np.ones((Nc, L), bool)
    if n_pad:
        mask_c[:, L - n_pad:] = False
    mask = np.repeat(mask_c, reps, 0)
    jblock = JBlock(F, Cz, num_heads=H)
    params, tblocks = [], []
    for i in range(LAYERS):
        p = jblock.init(jax.random.key(seed + 10 * i), jnp.asarray(R),
                        jnp.asarray(t), jnp.asarray(x),
                        jnp.asarray(np.repeat(z, reps, 0)), jnp.asarray(mask))
        p = _perturb(p, seed + 10 * i + 1)
        tb = GABlock(F, Cz, num_heads=H)
        tb.load_state_dict(ga_block_state_dict(p['params']))
        params.append(p)
        tblocks.append(tb)
    inputs = dict(R=R, t=t, x=x, z=z, mask=mask, mask_c=mask_c, reps=reps)
    return jblock, params, tblocks, inputs


def _port_chain(tblocks, c, dtype):
    """The port's chain on CPU tensors (its plain version)."""
    N, L = c['mask'].shape
    z = tt(c['z']).to(dtype)
    with torch.no_grad():
        stacked = gb.stack_encoder_weights(
            [gb.build_gablock_weights(b, dtype) for b in tblocks])
        biases = torch.stack(
            [precompute_pair_bias(z, b.proj_pair_bias.weight.t(),
                                  tt(c['mask_c']), dtype) for b in tblocks],
            dim=1)
        return gb.fused_encoder_chained(
            stacked, LAYERS, tt(c['R']).reshape(N, L, 9), tt(c['t']),
            tt(c['x']), z, biases, tt(c['mask']).float(), c['reps']).numpy()


@pytest.mark.parametrize('Nc,reps,n_pad,rt', [(1, 4, 0, 2), (2, 2, 3, None)])
def test_plain_chain_bf16_matches_jax_chained_kernel(Nc, reps, n_pad, rt):
    from ab_opt_tpu.ops.gablock_pallas import (build_gablock_weights,
                                               fused_encoder_chained,
                                               stack_encoder_weights,
                                               transpose_pair_for_fused)
    from ab_opt_tpu.ops.ipa_pallas import precompute_pair_bias as j_bias
    _, params, tblocks, c = _chain_case(Nc, reps, n_pad, seed=7)
    bf = jnp.bfloat16
    zb = jnp.asarray(c['z']).astype(bf)
    bps = [jax.tree_util.tree_map(jnp.asarray, p['params']) for p in params]
    stacked = stack_encoder_weights([build_gablock_weights(bp) for bp in bps])
    biases = jnp.stack([
        j_bias(zb, bp['proj_pair_bias']['kernel'].astype(bf),
               jnp.asarray(c['mask_c']), out_dtype=bf) for bp in bps], axis=1)
    N, L = c['mask'].shape
    want = np.asarray(fused_encoder_chained(
        stacked, LAYERS, jnp.asarray(c['R']).reshape(N, L, 9),
        jnp.asarray(c['t']), jnp.asarray(c['x']), transpose_pair_for_fused(zb),
        biases, jnp.asarray(c['mask'], jnp.float32), reps=reps, rt=rt,
        interpret=True, body_opts=None))
    gb.reset_counts()
    got = _port_chain(tblocks, c, torch.bfloat16)
    assert gb.fused_encoder_chained_reference.calls == 1
    assert gb.gablock_layer_reference.calls == 0
    valid = c['mask']
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=0.05, rtol=0.05)


@pytest.mark.parametrize('Nc,reps,n_pad', [(1, 4, 0), (2, 2, 3)])
def test_plain_chain_f32_matches_jax_gablocks(Nc, reps, n_pad):
    jblock, params, tblocks, c = _chain_case(Nc, reps, n_pad, seed=3)
    x = jnp.asarray(c['x'])
    for p in params:
        x = jblock.apply(p, jnp.asarray(c['R']), jnp.asarray(c['t']), x,
                         jnp.asarray(c['z']), jnp.asarray(c['mask']),
                         reps=reps)
    got = _port_chain(tblocks, c, torch.float32)
    np.testing.assert_allclose(got, np.asarray(x), atol=1e-4, rtol=0)


@pytest.fixture(scope='module')
def models():
    """A port DiffAb (float32, 2 layers, 4 steps, seeded torch init), the
    JAX DiffAb (einsum IPA) carrying the same weights through the weight
    bridge, and one synthetic complex at L=24."""
    from ab_opt_tpu.models import DiffAb as JDiffAb
    from ab_opt_tpu.models import DiffAbConfig as JConfig
    from ab_opt_tpu.utils.bench_fixture import synthetic_batch
    from ab_opt_tpu.utils.torch_convert import convert_diffab_state_dict
    from ab_opt_tpu_torch.data.collate import to_device_batch
    from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig
    kw = dict(res_feat_dim=32, pair_feat_dim=16, num_layers=2, num_steps=4)
    torch.manual_seed(0)
    tmodel = DiffAb(DiffAbConfig(**kw))
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_diffab_state_dict(tmodel.state_dict(), 2))
    jmodel = JDiffAb(JConfig(ipa_impl='einsum', **kw))
    jbatch = synthetic_batch(np.random.default_rng(0), N=1, L=24, n_ab=16,
                             gen_lo=6, gen_hi=12)
    tbatch = to_device_batch({k: np.array(v) for k, v in jbatch.items()})
    return jmodel, params, jbatch, tmodel, tbatch


def test_chained_reverse_steps_match_jax(models, monkeypatch):
    """Every reverse step of the JAX trajectory (keep_traj), restarted from
    JAX's own state, through the port's chained route: port step t -> t-1
    against JAX's next state, same draws."""
    from ab_opt_tpu.geometry import so3vec_to_rotation as j_rot
    from ab_opt_tpu_torch.geometry import so3vec_to_rotation as t_rot
    from test_torch_sample import _jax_draws
    monkeypatch.setenv('AB_OPT_FUSED_CHAIN', '1')
    reps, steps = 2, 4
    jmodel, params, jbatch, tmodel, tbatch = models
    key = jax.random.key(8)
    traj = jmodel.sample(params, jbatch, key, num_replicas=reps,
                         keep_traj=True)['traj']
    draws = _jax_draws(key, reps, 24, steps)['steps']
    rep = lambda a: a.repeat_interleave(reps, 0)
    gb.reset_counts()
    with torch.no_grad():
        res_feat, pair_feat, _, _ = tmodel.encode(tbatch, True, True)
        gen, mres = rep(tbatch['generate_flag']), rep(tbatch['mask'])
        denoiser = tmodel.prepare_denoiser(pair_feat, mres, reps)
        for i in range(1, steps):
            a = lambda x: torch.from_numpy(np.array(x[i - 1]))
            v, p, s, _, _ = tmodel.reverse_step(
                a(traj['v']), tmodel.normalize_position(a(traj['p'])),
                a(traj['s']).long(), steps - i, rep(res_feat), pair_feat,
                gen, mres, denoiser, reps, draws[i])
            np.testing.assert_allclose(
                tmodel.unnormalize_position(p).numpy(),
                np.asarray(traj['p'][i]), atol=1e-3, rtol=0)
            np.testing.assert_allclose(t_rot(v).numpy(),
                                       np.asarray(j_rot(traj['v'][i])),
                                       atol=1e-3, rtol=0)
            np.testing.assert_array_equal(s.numpy(), np.asarray(traj['s'][i]))
    assert gb.fused_encoder_chained_reference.calls == steps - 1
    assert gb.gablock_layer_reference.calls == 0


@pytest.mark.parametrize('env,layers,impl,want_layer_calls', [
    (None, 2, 'auto', 2), ('0', 2, 'auto', 2), ('1', 1, 'auto', 1),
    ('1', 2, 'pallas', 0), ('1', 2, 'pallas_fused', 0)])
def test_chain_taken_only_where_jax_takes_it(models, monkeypatch, env, layers,
                                             impl, want_layer_calls):
    """One denoiser evaluation: the chain runs with AB_OPT_FUSED_CHAIN set
    to anything but '0', more than one layer and the 'auto' or
    'pallas_fused' route; otherwise the per-layer route (or, for 'pallas',
    the eager encoder) runs."""
    import dataclasses
    from ab_opt_tpu_torch.models import DiffAb
    if env is None:
        monkeypatch.delenv('AB_OPT_FUSED_CHAIN', raising=False)
    else:
        monkeypatch.setenv('AB_OPT_FUSED_CHAIN', env)
    base = models[3]
    torch.manual_seed(0)
    model = DiffAb(dataclasses.replace(base.cfg, num_layers=layers,
                                       ipa_impl=impl))
    batch = models[4]
    gb.reset_counts()
    with torch.no_grad():
        res_feat, pair_feat, R0, p0 = model.encode(batch, True, True)
        from ab_opt_tpu_torch.geometry import rotation_to_so3vec
        enc, hw = model.prepare_denoiser(pair_feat, batch['mask'], 1)
        beta = torch.full((1,), 0.1)
        out = model.eps_net(rotation_to_so3vec(R0), p0 / 10.0, batch['aa'],
                            res_feat, pair_feat, beta, batch['generate_flag'],
                            batch['mask'], encoder_fn=enc, head_weights=hw)
    assert all(torch.isfinite(o).all() for o in out)
    chained = env not in (None, '0') and layers > 1 and impl != 'pallas'
    assert gb.fused_encoder_chained_reference.calls == int(chained)
    assert gb.gablock_layer_reference.calls == (0 if chained
                                                else want_layer_calls)


def _meta_chain_args(N=2, L=32, H=12, reps=1, NL=6, x_dtype=torch.float32,
                     bias_layers=None):
    """Chain-shaped arguments on the meta device (shapes, no data)."""
    f32, bf16 = torch.float32, torch.bfloat16
    e = lambda *s, dtype=f32: torch.empty(*s, dtype=dtype, device='meta')
    F, Nc = 128, N // reps
    stacked = {'w_proj': e(NL, F, 2048, dtype=bf16), 'coef': e(NL, H),
               'w_out': e(NL, H * 152, F, dtype=bf16), 'b_out': e(NL, F),
               'ln1': e(NL, 2, F), 'w_m1': e(NL, F, F, dtype=bf16),
               'w_m2': e(NL, F, F, dtype=bf16),
               'w_m3': e(NL, F, F, dtype=bf16), 'b_m': e(NL, 3, F),
               'ln2': e(NL, 2, F), 'dims': (H, 32, 32, 8, 8)}
    biases = e(Nc, bias_layers or NL, H, L, L, dtype=bf16)
    return (stacked, NL, e(N, L, 9), e(N, L, 3), e(N, L, F, dtype=x_dtype),
            e(Nc, L, L, 64, dtype=bf16), biases, e(N, L), reps)


@pytest.mark.parametrize('kw,match', [
    (dict(x_dtype=torch.float16), 'x dtype'),
    (dict(bias_layers=5), 'biases shape'),
    (dict(L=24), 'L=24'),
    (dict(H=6), 'H=6'),
    (dict(N=3, reps=2), 'reps=2'),
    (dict(), 'CUDA device')])
def test_chain_wrapper_raises_and_never_falls_back(kw, match):
    gb.reset_counts()
    with pytest.raises(ValueError, match=match):
        gb.fused_encoder_chained(*_meta_chain_args(**kw))
    assert gb.fused_encoder_chained_reference.calls == 0
    assert gb.fused_encoder_chained.launches == 0


def test_chain_wrapper_raises_without_a_cuda_build(monkeypatch, tmp_path):
    """With no toolkit the build raises, and the wrapper passes that on
    instead of falling back to the plain version."""
    monkeypatch.setattr('shutil.which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(gb.build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(gb, '_check_chain_inputs', lambda *a: None)
    gb._chain_library.cache_clear()
    gb.reset_counts()
    with pytest.raises(RuntimeError, match='nvcc not found'):
        gb.fused_encoder_chained(*_meta_chain_args())
    assert gb.fused_encoder_chained_reference.calls == 0
    assert gb.fused_encoder_chained.launches == 0


def test_chain_cpu_input_takes_the_plain_version():
    torch.manual_seed(4)
    N, L = 2, 16
    q = torch.randn(N, L, 4)
    from ab_opt_tpu_torch.geometry import quaternion_to_rotation_matrix
    c = dict(R=quaternion_to_rotation_matrix(q).numpy(),
             t=torch.randn(N, L, 3).numpy(), x=torch.randn(N, L, 32).numpy(),
             z=torch.randn(1, L, L, 16).numpy(), mask=np.ones((N, L), bool),
             mask_c=np.ones((1, L), bool), reps=2)
    tblocks = [GABlock(32, 16, num_heads=4) for _ in range(LAYERS)]
    gb.reset_counts()
    _port_chain(tblocks, c, torch.float32)
    assert gb.fused_encoder_chained_reference.calls == 1
    assert gb.fused_encoder_chained.launches == 0
    assert gb.gablock_layer_reference.calls == 0


def test_stack_encoder_weights_keeps_each_layer():
    torch.manual_seed(1)
    blocks = [GABlock(32, 16, num_heads=4) for _ in range(3)]
    bundles = [gb.build_gablock_weights(b) for b in blocks]
    stacked = gb.stack_encoder_weights(bundles)
    assert stacked['dims'] == bundles[0]['dims']
    for k, v in stacked.items():
        if k == 'dims':
            continue
        assert v.shape[0] == 3 and v.is_contiguous(), k
        for i in range(3):
            assert torch.equal(v[i], bundles[i][k]), (k, i)
