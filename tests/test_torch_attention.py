"""The IPA attention port (ab_opt_tpu_torch.ops.ipa_attention) and the
GABlock training path against the JAX package, on the CPU:

* the plain forward against JAX ``_attention_fwd_call`` (interpret mode),
  out and alphas at 2e-5 (float32), reps 1 and 3;
* the plain backward against JAX ``_attention_bwd_call`` (interpret mode)
  and, with the replica sum of dbias, against the custom VJP of
  ``_fused_attention``, with a nonzero dalphas, at 1e-4;
* the plain backward against torch.autograd through the plain forward;
* the GABlock (forward and parameter gradients) against the JAX
  ``GABlock(use_pallas=True)`` in interpret mode: float32 at 2e-4 (forward)
  and 2e-4 x the tensor's max (gradients), bf16 forward at 0.05 on valid
  rows;
* the wrappers: CPU tensors take the plain versions; anything else launches
  the kernel or raises (never falls back).
The kernels themselves are held against the plain versions on a card in
tests/test_torch_cuda.py.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.nn.ipa import GABlock  # noqa: E402
from ab_opt_tpu_torch.ops import ipa_attention as ia  # noqa: E402
from ab_opt_tpu_torch.utils.convert import ga_block_state_dict  # noqa: E402

H = 12


def _operands(N, L, reps, seed=0, n_pad=3):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    qa, ka = f(N, L, H * 64, scale=0.5), f(N, L, H * 64, scale=0.5)
    vvp, dout = f(N, L, H * 64), f(N, L, H * 64)
    bias = f(N // reps, H, L, L)
    bias[..., L - n_pad:] -= 1e5
    dalphas = f(N, H, L, L, scale=0.3)
    return qa, ka, vvp, bias, dout, dalphas


CASES = [(2, 16, 1), (3, 24, 3)]


@pytest.mark.parametrize('N,L,reps', CASES)
def test_fwd_reference_matches_jax(N, L, reps):
    from ab_opt_tpu.ops.ipa_pallas import _attention_fwd_call
    qa, ka, vvp, bias, _, _ = _operands(N, L, reps)
    want = _attention_fwd_call(*map(jnp.asarray, (qa, ka, vvp, bias)),
                               interpret=True, reps=reps)
    got = ia.ipa_attention_fwd_reference(
        *map(torch.from_numpy, (qa, ka, vvp, bias)), reps)
    for a, b, name in zip(got, want, ('out', 'alphas')):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize('N,L,reps', CASES)
def test_bwd_reference_matches_jax(N, L, reps):
    from ab_opt_tpu.ops.ipa_pallas import _attention_bwd_call, _fused_attention
    qa, ka, vvp, bias, dout, dalphas = _operands(N, L, reps, seed=1)
    j = lambda *a: tuple(map(jnp.asarray, a))
    (out, alphas), vjp = jax.vjp(
        lambda *x: _fused_attention(True, reps, *x), *j(qa, ka, vvp, bias))
    want_kernel = _attention_bwd_call(*j(qa, ka, vvp), alphas,
                                      *j(dout, dalphas), interpret=True)
    want_vjp = vjp(j(dout, dalphas))
    t = torch.from_numpy
    got = ia.ipa_attention_bwd_reference(t(qa), t(ka), t(vvp),
                                         t(np.array(alphas)), t(dout),
                                         t(dalphas))
    names = ('dqa', 'dka', 'dvvp', 'dbias')
    for a, b, name in zip(got, want_kernel, names):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0, err_msg=name)
    # Through the autograd function: dbias summed over the replicas.
    leaves = [t(a).requires_grad_() for a in (qa, ka, vvp, bias)]
    o, al = ia.ipa_attention(*leaves, reps=reps)
    ((o * t(dout)).sum() + (al * t(dalphas)).sum()).backward()
    assert leaves[3].grad.shape == bias.shape
    for leaf, b, name in zip(leaves, want_vjp, names):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b),
                                   atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize('N,L,reps', CASES)
def test_bwd_reference_matches_autograd(N, L, reps):
    qa, ka, vvp, bias, dout, dalphas = map(torch.from_numpy,
                                          _operands(N, L, reps, seed=2))
    leaves = [a.clone().requires_grad_() for a in (qa, ka, vvp, bias)]
    out, alphas = ia.ipa_attention_fwd_reference(*leaves, reps)
    ((out * dout).sum() + (alphas * dalphas).sum()).backward()
    got = ia.ipa_attention_bwd_reference(qa, ka, vvp, alphas.detach(), dout,
                                         dalphas)
    dbias = got[3].reshape(N // reps, reps, H, L, L).sum(1)
    for a, leaf, name in zip(got[:3] + (dbias,), leaves,
                             ('dqa', 'dka', 'dvvp', 'dbias')):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_p2n_aggregate_matches_jax():
    from ab_opt_tpu.ops.ipa_pallas import p2n_aggregate as j_p2n
    rng = np.random.default_rng(3)
    N, L, reps, Cz = 4, 16, 2, 8
    alphas = rng.random((N, H, L, L)).astype(np.float32)
    z = rng.standard_normal((N // reps, L, L, Cz)).astype(np.float32)
    for r, zz in ((1, np.repeat(z, reps, 0)), (reps, z)):
        want = j_p2n(jnp.asarray(alphas), jnp.asarray(zz), r)
        got = ia.p2n_aggregate(torch.from_numpy(alphas), torch.from_numpy(zz),
                               r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


# ------------------------------------------------------------ GABlock


@functools.lru_cache(maxsize=None)
def _block_init(F, Cz):
    """The JAX GABlock's init, jitted once per width (eager flax init
    costs seconds of per-op dispatch)."""
    from ab_opt_tpu.nn.ipa import GABlock as JBlock
    return jax.jit(JBlock(F, Cz, num_heads=H).init)


def _block_case(Nc, reps, dtype, L=16, F=32, Cz=16, n_pad=3, seed=0):
    """Inputs (numpy), JAX GABlock params (einsum init, float32) and the
    port block carrying them."""
    from ab_opt_tpu.geometry import quaternion_to_rotation_matrix
    from ab_opt_tpu.nn.ipa import GABlock as JBlock
    rng = np.random.default_rng(seed)
    N = Nc * reps
    q = rng.normal(size=(N, L, 4)).astype(np.float32)
    R = np.array(jax.jit(quaternion_to_rotation_matrix)(jnp.asarray(q)))
    t = (rng.normal(size=(N, L, 3)) * 3).astype(np.float32)
    x = rng.normal(size=(N, L, F)).astype(np.float32)
    z = rng.normal(size=(Nc, L, L, Cz)).astype(np.float32)
    mask_c = np.ones((Nc, L), bool)
    mask_c[:, L - n_pad:] = False
    mask = np.repeat(mask_c, reps, 0)
    params = _block_init(F, Cz)(
        jax.random.key(seed), jnp.asarray(R), jnp.asarray(t), jnp.asarray(x),
        jnp.asarray(np.repeat(z, reps, 0)), jnp.asarray(mask))
    noise = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * noise.standard_normal(np.shape(a)).astype(np.float32), params)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jblock = JBlock(F, Cz, num_heads=H, dtype=jdt, use_pallas=True)
    tblock = GABlock(F, Cz, num_heads=H, dtype=dtype)
    tblock.load_state_dict(ga_block_state_dict(params['params']))
    inputs = dict(R=R, t=t, x=x, z=z, mask=mask, reps=reps,
                  ct=rng.normal(size=(N, L, F)).astype(np.float32))
    return jblock, params, tblock, inputs


def _jax_block(jblock, params, c):
    def f(p):
        y = jblock.apply(p, jnp.asarray(c['R']), jnp.asarray(c['t']),
                         jnp.asarray(c['x']), jnp.asarray(c['z']),
                         jnp.asarray(c['mask']), reps=c['reps'])
        return jnp.sum(y * c['ct']), y
    (_, y), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return np.asarray(y), ga_block_state_dict(g['params'])


def _port_block(tblock, c):
    t = torch.from_numpy
    tblock.zero_grad()
    ia.reset_counts()
    y = tblock(t(c['R']), t(c['t']), t(c['x']), t(c['z']), t(c['mask']),
               reps=c['reps'])
    (y * t(c['ct'])).sum().backward()
    assert ia.ipa_attention_fwd_reference.calls == 1
    assert ia.ipa_attention_bwd_reference.calls == 1
    return y.detach().numpy(), {k: p.grad for k, p in tblock.named_parameters()}


@pytest.mark.parametrize('Nc,reps', [(2, 1), (1, 2)])
def test_gablock_training_path_matches_jax_f32(Nc, reps):
    jblock, params, tblock, c = _block_case(Nc, reps, torch.float32)
    want_y, want_g = _jax_block(jblock, params, c)
    got_y, got_g = _port_block(tblock, c)
    np.testing.assert_allclose(got_y, want_y, atol=2e-4, rtol=0)
    assert sorted(got_g) == sorted(want_g)
    for name, g in got_g.items():
        w = want_g[name].numpy()
        tol = 2e-4 * max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0,
                                   err_msg=name)


def test_gablock_training_path_matches_jax_bf16():
    jblock, params, tblock, c = _block_case(2, 1, torch.bfloat16, seed=4)
    want_y, _ = _jax_block(jblock, params, c)
    got_y, got_g = _port_block(tblock, c)
    valid = c['mask']
    assert np.isfinite(got_y).all()
    assert all(torch.isfinite(g).all() for g in got_g.values())
    np.testing.assert_allclose(got_y[valid], want_y[valid], atol=0.05,
                               rtol=0.05)


# ------------------------------------------------------------ wrappers


def _meta(dtype=torch.float32, L=32, reps=1, N=2):
    e = lambda *s: torch.empty(*s, dtype=dtype, device='meta')
    return (e(N, L, H * 64), e(N, L, H * 64), e(N, L, H * 64),
            e(N // reps, H, L, L))


@pytest.mark.parametrize('bad,match', [
    (dict(dtype=torch.float16), 'dtype'), (dict(L=520), 'L=520'),
    (dict(L=24), 'L=24'), (dict(reps=3, N=4), 'reps=3'), ({}, 'CUDA device')])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        ia.ipa_attention_fwd(*_meta(**bad), reps=bad.get('reps', 1))


def test_wrapper_raises_without_a_cuda_build(monkeypatch, tmp_path):
    """With no toolkit the build raises, and the wrapper passes that on
    instead of falling back to the plain version."""
    from ab_opt_tpu_torch.ops import build
    monkeypatch.setattr('shutil.which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(ia, '_check', lambda *a, **k: (2, 32, H))
    ia._library.cache_clear()
    ia.reset_counts()
    with pytest.raises(RuntimeError, match='nvcc not found'):
        ia.ipa_attention_fwd(*_meta())
    ia._library.cache_clear()
    assert ia.ipa_attention_fwd_reference.calls == 0
    assert ia.ipa_attention_fwd.launches == 0


def test_cpu_tensors_take_the_plain_versions():
    qa, ka, vvp, bias, dout, dalphas = map(torch.from_numpy,
                                          _operands(2, 16, 2))
    leaves = [a.requires_grad_() for a in (qa, ka, vvp, bias)]
    ia.reset_counts()
    out, alphas = ia.ipa_attention(*leaves, reps=2)
    ((out * dout).sum() + (alphas * dalphas).sum()).backward()
    assert (ia.ipa_attention_fwd_reference.calls,
            ia.ipa_attention_bwd_reference.calls) == (1, 1)
    assert (ia.ipa_attention_fwd.launches, ia.ipa_attention_bwd.launches) == (0, 0)
