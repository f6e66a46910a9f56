"""K4, the attention forward with the pair aggregation in the kernel
(ab_opt_tpu_torch.ops.ipa_attention.ipa_attention_fwd_p2n), and the sampling
form of the GABlock that runs it, against the JAX package on the CPU:

* the plain version against JAX ``_attention_fwd_p2n_call`` in interpret
  mode, reps 1 and 3, L 16 and 48, padded key columns: out and p2n at 1e-5
  in float32, within the bf16 kernel budget (atol/rtol 0.05) in bfloat16;
* ``GABlock(fuse_p2n=True)`` against the JAX ``GABlock(use_pallas=True)``
  called with ``fuse_p2n=True`` (K4 in interpret mode), float32, at 1e-4;
* the same at L=144 with reps 4 (a ragged query tile, blocks of four
  replicas);
* the launch plan (``fwd_p2n_plan``, a pure function of the shapes): the
  route by dtype, L, H and Cz, and at L 16..256 x H 4, 8, 12, 16 x reps 1,
  2, 3, 4, 256 every (trajectory, query row, head) covered by exactly one
  block of each launch, in at most 232,448 bytes of shared memory;
* the wrapper: it raises on shapes, dtypes and widths the kernel does not
  take and on any input that requires a gradient, and CPU tensors take the
  plain version.
The kernel itself is held against the plain version on a card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.ops import ipa_attention as ia  # noqa: E402
from test_torch_attention import _block_case  # noqa: E402

H = 12


def _operands(Nc, reps, L, Cz=16, n_pad=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    N = Nc * reps
    qa, ka = f(N, L, H * 64, scale=0.5), f(N, L, H * 64, scale=0.5)
    vvp = f(N, L, H * 64)
    bias = f(Nc, H, L, L)
    bias[..., L - n_pad:] -= 1e5                 # padded key columns
    return qa, ka, vvp, bias, f(Nc, L, L, Cz)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('L', [16, 48])
@pytest.mark.parametrize('Nc,reps', [(2, 1), (1, 3)])
def test_p2n_reference_matches_jax(Nc, reps, L, dtype):
    from ab_opt_tpu.ops.ipa_pallas import _attention_fwd_p2n_call
    ops = _operands(Nc, reps, L, seed=L + reps)
    jdt = getattr(jnp, dtype)
    want = _attention_fwd_p2n_call(*(jnp.asarray(a, jdt) for a in ops),
                                   interpret=True, reps=reps)
    tdt = getattr(torch, dtype)
    got = ia.ipa_attention_fwd_p2n_reference(
        *(torch.from_numpy(a).to(tdt) for a in ops), reps)
    tol = 1e-5 if dtype == 'float32' else 0.05
    for a, b, name in zip(got, want, ('out', 'p2n')):
        assert a.dtype == tdt and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=tol, rtol=0 if tol < 1e-3 else tol,
                                   err_msg=name)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_p2n_reference_matches_jax_at_L144(dtype):
    test_p2n_reference_matches_jax(1, 4, 144, dtype)


@pytest.mark.parametrize('Nc,reps', [(2, 1), (1, 2)])
def test_gablock_sampling_form_matches_jax(Nc, reps):
    jblock, params, tblock, c = _block_case(Nc, reps, torch.float32)
    want = jax.jit(lambda p: jblock.apply(
        p, jnp.asarray(c['R']), jnp.asarray(c['t']), jnp.asarray(c['x']),
        jnp.asarray(c['z']), jnp.asarray(c['mask']), reps=reps,
        fuse_p2n=True))(params)
    t = torch.from_numpy
    ia.reset_counts()
    with torch.no_grad():
        got = tblock(t(c['R']), t(c['t']), t(c['x']), t(c['z']),
                     t(c['mask']), reps=reps, fuse_p2n=True)
    assert ia.ipa_attention_fwd_p2n_reference.calls == 1
    assert ia.ipa_attention_fwd_reference.calls == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_gablock_sampling_form_needs_no_grad():
    """With gradients on, the block's operands require a gradient and K4,
    which has no backward, refuses them."""
    _, _, tblock, c = _block_case(2, 1, torch.float32)
    t = torch.from_numpy
    with pytest.raises(ValueError, match='requires a gradient'):
        tblock(t(c['R']), t(c['t']), t(c['x']), t(c['z']), t(c['mask']),
               fuse_p2n=True)


# ------------------------------------------------------------ the wrapper


def _meta(dtype=torch.float32, L=32, reps=1, N=2, heads=H, Cz=64, Nz=None):
    e = lambda *s: torch.empty(*s, dtype=dtype, device='meta')
    return (e(N, L, heads * 64), e(N, L, heads * 64), e(N, L, heads * 64),
            e(N // reps, heads, L, L), e(Nz or N // reps, L, L, Cz))


@pytest.mark.parametrize('bad,match', [
    (dict(dtype=torch.float16), 'dtype'), (dict(L=520), 'L=520'),
    (dict(L=24), 'L=24'), (dict(reps=3, N=4), 'reps=3'),
    (dict(Cz=66), 'Cz=66'), (dict(Cz=6), 'Cz=6'), (dict(heads=20), 'H=20'),
    (dict(Nz=2, reps=2), 'z shape'), ({}, 'CUDA device')])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        ia.ipa_attention_fwd_p2n(*_meta(**bad), reps=bad.get('reps', 1))


@pytest.mark.parametrize('which', range(5))
def test_wrapper_raises_on_a_tensor_that_requires_grad(which):
    args = [torch.from_numpy(a) for a in _operands(1, 2, 16)]
    args[which].requires_grad_()
    ia.reset_counts()
    with pytest.raises(ValueError, match='requires a gradient'):
        ia.ipa_attention_fwd_p2n(*args, reps=2)
    assert ia.ipa_attention_fwd_p2n_reference.calls == 0


def test_cpu_tensors_take_the_plain_version():
    args = [torch.from_numpy(a) for a in _operands(1, 2, 16)]
    ia.reset_counts()
    out, p2n = ia.ipa_attention_fwd_p2n(*args, reps=2)
    assert out.shape == (2, 16, H * 64) and p2n.shape == (2, 16, H, 16)
    assert ia.ipa_attention_fwd_p2n_reference.calls == 1
    assert ia.ipa_attention_fwd_p2n.launches == 0
    # The same out as K2's plain version, and p2n = alphas . z.
    ref_out, alphas = ia.ipa_attention_fwd_reference(*args[:4], reps=2)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(p2n, ia.p2n_aggregate(alphas, args[4], 2),
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize('dtype,L,heads,Cz,route', [
    (torch.bfloat16, 128, 12, 64, 'tile'), (torch.bfloat16, 16, 4, 64, 'tile'),
    (torch.bfloat16, 256, 20, 64, 'tile'),
    (torch.bfloat16, 272, 12, 64, 'cuda_cores'),
    (torch.bfloat16, 512, 12, 16, 'cuda_cores'),
    (torch.float32, 128, 12, 64, 'cuda_cores'),
    (torch.float32, 48, 12, 16, 'cuda_cores'),
    (torch.bfloat16, 128, 12, 16, 'cuda_cores'),
    (torch.bfloat16, 256, 6, 64, 'cuda_cores')])
def test_plan_route(dtype, L, heads, Cz, route):
    """bf16 up to L=256 with Cz=64 and a multiple of 4 heads takes K1's
    attention tile; float32, bf16 past L=256, and bf16 with another Cz or
    H (as JAX's kernel takes any) the CUDA-core tiles."""
    plan = ia.fwd_p2n_plan(dtype, 8, L, heads, Cz, 4)
    assert plan['route'] == route
    assert all(launch['smem'] <= ia.SMEM_BLOCK for launch in plan['launches'])


@pytest.mark.parametrize('dtype,L,heads,Cz,match', [
    (torch.float32, 128, 20, 64, 'H=20'), (torch.float16, 128, 12, 64, 'dtype'),
    (torch.bfloat16, 136, 12, 64, 'L=136'), (torch.float32, 528, 12, 64,
                                             'L=528')])
def test_plan_refuses_what_no_route_takes(dtype, L, heads, Cz, match):
    with pytest.raises(ValueError, match=match):
        ia.fwd_p2n_plan(dtype, 8, L, heads, Cz, 4)


def _cover(length, starts, width):
    """How often each of ``length`` indices is covered by blocks starting at
    ``starts``, each ``width`` wide (clipped at the end)."""
    count = np.zeros(length + width, dtype=np.int64)
    for s0 in starts:
        count[s0:s0 + width] += 1
    return count[:length]


@pytest.mark.parametrize('reps', [1, 2, 3, 4, 256])
@pytest.mark.parametrize('heads', [4, 8, 12, 16])
def test_plan_covers_every_row_once(heads, reps):
    """At every L 16..256 (step 16), each launch of the tile route (the
    attention, then p2n) covers every (trajectory, query row, head) exactly
    once, no block is empty, each takes at most 232,448 bytes of shared
    memory, and the replica groups divide reps."""
    Nc = 2 if reps < 256 else 1
    N = Nc * reps
    for L in range(16, 257, 16):
        plan = ia.fwd_p2n_plan(torch.bfloat16, N, L, heads, 64, reps)
        assert plan['route'] == 'tile' and reps % plan['rt'] == 0
        assert plan['workspace_bytes'] == N * heads * L * L * 2
        rt, qt, rows = plan['rt'], plan['query_rows'], plan['p2n_rows']
        (attn, p2n) = plan['launches']
        for launch in plan['launches']:
            assert launch['smem'] <= ia.SMEM_BLOCK, (L, launch)
            assert max(launch['grid'][1:]) <= 65535, (L, launch)
        # The attention: (query tile, head, replica group).
        gx, gy, gz = attn['grid']
        i = _cover(L, range(0, gx * qt, qt), qt)
        h = _cover(heads, range(gy), 1)
        n = _cover(N, range(0, gz * rt, rt), rt)
        assert gx * qt - L < qt and gz * rt == N, (L, attn)
        assert (np.einsum('n,i,h->nih', n, i, h) == 1).all(), (L, attn)
        # The p2n: (alpha-row block, query rows, complex); alpha row m of
        # complex c is trajectory c reps + m // H, head m % H.
        gx, gy, gz = p2n['grid']
        m = _cover(reps * heads, range(0, gx * ia.P2N_M, ia.P2N_M), ia.P2N_M)
        i = _cover(L, range(0, gy * rows, rows), rows)
        c = _cover(Nc, range(gz), 1)
        assert gx * ia.P2N_M - reps * heads < ia.P2N_M, (L, p2n)
        assert gy * rows - L < rows, (L, p2n)
        cover = np.einsum('c,rh,i->crih', c, m.reshape(reps, heads), i)
        assert (cover.reshape(N, L, heads) == 1).all(), (L, p2n)
