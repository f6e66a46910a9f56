"""The GABlock port (ab_opt_tpu_torch.nn.ipa, ab_opt_tpu_torch.ops.gablock)
against the JAX GABlock and the JAX fused GABlock kernel.

* eager GABlock and the kernel's plain version in float32 against the JAX
  GABlock module (einsum path, float32): atol 1e-4;
* the plain version in bf16 against JAX ``fused_gablock_layer`` (interpret
  mode, base body ``body_opts=None``): atol/rtol 0.05 on valid rows, the
  budget of tests/test_ipa_pallas.py:230;
* the wrapper: CPU tensors take the plain version; anything else launches
  the kernel or raises (never falls back).
The kernel itself is held against its plain version on a card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.nn.ipa import GABlock, precompute_pair_bias  # noqa: E402
from ab_opt_tpu_torch.ops import gablock as gb  # noqa: E402
from ab_opt_tpu_torch.utils.convert import ga_block_state_dict  # noqa: E402


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _case(Nc, reps, L=16, F=32, Cz=16, H=4, n_pad=3, seed=0):
    """Inputs (numpy) plus JAX GABlock params and the matching port block."""
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
    params = jblock.init(jax.random.key(seed), jnp.asarray(R), jnp.asarray(t),
                         jnp.asarray(x), jnp.asarray(np.repeat(z, reps, 0)),
                         jnp.asarray(mask))
    params = _perturb(params, seed + 1)
    tblock = GABlock(F, Cz, num_heads=H)
    tblock.load_state_dict(ga_block_state_dict(params['params']))
    inputs = dict(R=R, t=t, x=x, z=z, mask=mask, mask_c=mask_c, reps=reps)
    return jblock, params, tblock, inputs


def _jax_module(jblock, params, c):
    return np.asarray(jblock.apply(params, jnp.asarray(c['R']),
                                   jnp.asarray(c['t']), jnp.asarray(c['x']),
                                   jnp.asarray(c['z']), jnp.asarray(c['mask']),
                                   reps=c['reps']))


def _plain(tblock, c, dtype):
    N, L = c['mask'].shape
    tt = torch.from_numpy
    z = tt(c['z']).to(dtype)
    bias = precompute_pair_bias(z, tblock.proj_pair_bias.weight.detach().t(),
                                tt(c['mask_c']), dtype)
    wb = gb.build_gablock_weights(tblock, dtype)
    return gb.gablock_layer(tt(c['x']), tt(c['R']).reshape(N, L, 9),
                            tt(c['t']), z, bias,
                            tt(c['mask']).float(), wb, c['reps']).numpy()


CASES = [(2, 1), (1, 2), (2, 2)]


@pytest.mark.parametrize('Nc,reps', CASES)
def test_eager_gablock_matches_jax(Nc, reps):
    jblock, params, tblock, c = _case(Nc, reps)
    want = _jax_module(jblock, params, c)
    tt = torch.from_numpy
    with torch.no_grad():
        got = tblock(tt(c['R']), tt(c['t']), tt(c['x']), tt(c['z']),
                     tt(c['mask']), reps=reps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('Nc,reps', CASES)
def test_plain_f32_matches_jax_gablock(Nc, reps):
    jblock, params, tblock, c = _case(Nc, reps)
    want = _jax_module(jblock, params, c)
    with torch.no_grad():
        got = _plain(tblock, c, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_plain_softmax_is_exact_past_logit_60(monkeypatch):
    """The TPU serving body (fast_softmax) clamps logits at 60; the port
    does an exact softmax. Inputs scaled so logits pass 60 still match the
    JAX module (exact softmax) in float32."""
    jblock, params, tblock, c = _case(2, 1)
    c['x'] = c['x'] * 12.0
    seen = []
    softmax = torch.softmax

    def spy(a, dim):
        seen.append(float(a.max()))
        return softmax(a, dim=dim)

    monkeypatch.setattr(torch, 'softmax', spy)
    with torch.no_grad():
        got = _plain(tblock, c, torch.float32)
    assert max(seen) > 60.0
    np.testing.assert_allclose(got, _jax_module(jblock, params, c), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize('Nc,reps,n_pad', [(2, 1, 0), (2, 1, 3), (1, 2, 3)])
def test_plain_bf16_matches_jax_fused_kernel(Nc, reps, n_pad):
    from ab_opt_tpu.ops.gablock_pallas import (build_gablock_weights,
                                               fused_gablock_layer,
                                               transpose_pair_for_fused)
    from ab_opt_tpu.ops.ipa_pallas import precompute_pair_bias as j_bias
    jblock, params, tblock, c = _case(Nc, reps, n_pad=n_pad, seed=5)
    bp = jax.tree_util.tree_map(jnp.asarray, params['params'])
    bf = jnp.bfloat16
    zb = jnp.asarray(c['z']).astype(bf)
    bias = j_bias(zb, bp['proj_pair_bias']['kernel'].astype(bf),
                  jnp.asarray(c['mask_c']), out_dtype=bf)
    N, L = c['mask'].shape
    want = np.asarray(fused_gablock_layer(
        jnp.asarray(c['x']), jnp.asarray(c['R']).reshape(N, L, 9),
        jnp.asarray(c['t']), transpose_pair_for_fused(zb), bias,
        jnp.asarray(c['mask'], jnp.float32), build_gablock_weights(bp),
        reps=reps, interpret=True, body_opts=None))
    with torch.no_grad():
        got = _plain(tblock, c, torch.bfloat16)
    valid = c['mask']
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=0.05, rtol=0.05)


def _meta_args(N=2, L=32, H=12, reps=1, x_dtype=torch.float32):
    """Kernel-shaped arguments on the meta device (shapes, no data)."""
    f32, bf16 = torch.float32, torch.bfloat16
    e = lambda *s, dtype=f32: torch.empty(*s, dtype=dtype, device='meta')
    F, Nc = 128, N // reps
    wb = {'w_proj': e(F, 2048, dtype=bf16), 'coef': e(H),
          'w_out': e(H * 152, F, dtype=bf16), 'b_out': e(F), 'ln1': e(2, F),
          'w_m1': e(F, F, dtype=bf16), 'w_m2': e(F, F, dtype=bf16),
          'w_m3': e(F, F, dtype=bf16), 'b_m': e(3, F), 'ln2': e(2, F),
          'dims': (H, 32, 32, 8, 8)}
    return (e(N, L, F, dtype=x_dtype), e(N, L, 9), e(N, L, 3),
            e(Nc, L, L, 64, dtype=bf16), e(Nc, H, L, L, dtype=bf16), e(N, L),
            wb, reps)


def test_wrapper_rejects_wrong_dtype():
    with pytest.raises(ValueError, match='x dtype'):
        gb.gablock_layer(*_meta_args(x_dtype=torch.float16))


def test_wrapper_rejects_non_cuda_device():
    with pytest.raises(ValueError, match='CUDA device'):
        gb.gablock_layer(*_meta_args())


def test_wrapper_raises_without_a_cuda_build(monkeypatch, tmp_path):
    """With no toolkit the build raises, and the wrapper passes that on
    instead of falling back to the plain version."""
    monkeypatch.setattr('shutil.which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(gb.build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(gb, '_check_inputs', lambda *a: None)
    gb._library.cache_clear()
    gb.reset_counts()
    with pytest.raises(RuntimeError, match='nvcc not found'):
        gb.gablock_layer(*_meta_args())
    assert gb.gablock_layer_reference.calls == 0
    assert gb.gablock_layer.launches == 0


def test_cpu_input_takes_the_plain_version():
    _, _, tblock, c = _case(1, 2, seed=3)
    gb.reset_counts()
    with torch.no_grad():
        _plain(tblock, c, torch.float32)
    assert gb.gablock_layer_reference.calls == 1
    assert gb.gablock_layer.launches == 0
