"""The attention variants S1-S3 (ab_opt_tpu_torch.ops.attention_variants)
against the JAX package, on the CPU:

* the plain versions against the script's own Pallas kernels,
  ``scripts/micro_kernel_variants.py`` ``v1_call`` (store_alphas True and
  False), ``v2_call`` and ``v4_call``, run in interpret mode: the script is
  loaded as a module of its own and its ``pl`` replaced by one whose
  ``pallas_call`` interprets (the script itself is not changed). f32 at
  atol 1e-5, bf16 at atol/rtol 0.05; L 16 and 48; (Nc, reps) (2, 1) and
  (1, 3); 3 padded key columns;
* the same at L=144 with reps 4 (a ragged query tile of K1's attention
  tile, which S1 and S3 run, and blocks of four replicas), and for S2 and
  S3 at their cap L=256 (one trajectory, bf16);
* the plans: S1's, S2's and S3's shared memory within a block's at every
  L they take, and S3's cluster partition: every (n, i, h) of p2n written
  once, each cluster's blocks on one complex and one query tile, each
  block's rows gathered from its own cluster;
* the wrappers: they refuse what the card kernels do not take (a dtype
  other than bf16, L past the cap of 256 or not a multiple of 16, reps
  not dividing N, wrong bias and z shapes, a tensor off the card, a tensor
  that requires a gradient), and CPU tensors take the plain version with
  no launch.
The kernels themselves are held against the plain versions on a card in
tests/test_torch_cuda.py.
"""
import functools
import importlib.util
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ab_opt_tpu_torch.ops import attention_variants as av  # noqa: E402
from ab_opt_tpu_torch.ops import ipa_attention as ia  # noqa: E402

H = 12
SCRIPT = (pathlib.Path(__file__).resolve().parents[1] / 'scripts'
          / 'micro_kernel_variants.py')


@pytest.fixture(scope='module')
def script():
    """micro_kernel_variants.py as a private module whose Pallas calls run
    in interpret mode."""
    spec = importlib.util.spec_from_file_location('_micro_kernel_variants',
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


def _operands(Nc, reps, L, Cz=16, n_pad=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    N = Nc * reps
    qa, ka = f(N, L, H * 64, scale=0.5), f(N, L, H * 64, scale=0.5)
    vvp = f(N, L, H * 64)
    bias = f(Nc, H, L, L)
    bias[..., L - n_pad:] -= 1e5                 # padded key columns
    return qa, ka, vvp, bias, f(Nc, L, L, Cz)


# variant -> (JAX call on the script's module, port wrapper, output names)
VARIANTS = {
    'v1': (lambda m, o, reps: m.v1_call(*o[:4], reps, True),
           lambda o, reps: av.attention_v1(*o[:4], reps), ('out', 'alphas')),
    'v3': (lambda m, o, reps: (m.v1_call(*o[:4], reps, False),),
           lambda o, reps: (av.attention_v1(*o[:4], reps,
                                            store_alphas=False),),
           ('out',)),
    'v2': (lambda m, o, reps: m.v2_call(*o[:4], reps),
           lambda o, reps: av.attention_v2(*o[:4], reps), ('out', 'alphas')),
    'v4': (lambda m, o, reps: m.v4_call(*o, reps),
           lambda o, reps: av.attention_v4(*o, reps), ('out', 'p2n')),
}


@pytest.mark.parametrize('variant', list(VARIANTS))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('L', [16, 48])
@pytest.mark.parametrize('Nc,reps', [(2, 1), (1, 3)])
def test_plain_version_matches_the_script(script, variant, Nc, reps, L,
                                          dtype):
    """Each variant's plain version (K2's or K4's) against the script's
    kernel, with the same seeded operands; CPU tensors launch nothing."""
    jax_call, port_call, names = VARIANTS[variant]
    ops = _operands(Nc, reps, L, seed=L + reps)
    want = jax_call(script, [jnp.asarray(a, getattr(jnp, dtype))
                             for a in ops], reps)
    tdt = getattr(torch, dtype)
    av.reset_counts()
    got = port_call([torch.from_numpy(a).to(tdt) for a in ops], reps)
    assert av.launches == {'v1': 0, 'v3': 0, 'v2': 0, 'v4': 0}
    tol = 1e-5 if dtype == 'float32' else 0.05
    assert len(got) == len(want) == len(names)
    for a, b, name in zip(got, want, names):
        assert a.dtype == tdt and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=tol, rtol=0 if tol < 1e-3 else tol,
                                   err_msg=name)


@pytest.mark.parametrize('variant', list(VARIANTS))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_version_matches_the_script_at_L144(script, variant, dtype):
    """As above at L=144, one complex of 4 replicas."""
    test_plain_version_matches_the_script(script, variant, 1, 4, 144, dtype)


@pytest.mark.parametrize('variant', ['v2', 'v4'])
def test_plain_version_matches_the_script_at_the_cap(script, variant):
    """As above at S2's and S3's cap L=256, one trajectory, bf16."""
    test_plain_version_matches_the_script(script, variant, 1, 1, 256,
                                          'bfloat16')


# ------------------------------------------------------------ the wrappers


def _meta(dtype=torch.bfloat16, L=32, reps=1, N=2, heads=H, Cz=64, Nb=None,
          Nz=None):
    e = lambda *s: torch.empty(*s, dtype=dtype, device='meta')
    return (e(N, L, heads * 64), e(N, L, heads * 64), e(N, L, heads * 64),
            e(Nb or N // reps, heads, L, L), e(Nz or N // reps, L, L, Cz))


CALLS = {
    'v1': lambda a, reps: av.attention_v1(*a[:4], reps=reps),
    'v3': lambda a, reps: av.attention_v1(*a[:4], reps=reps,
                                          store_alphas=False),
    'v2': lambda a, reps: av.attention_v2(*a[:4], reps=reps),
    'v4': lambda a, reps: av.attention_v4(*a, reps=reps),
}
COMMON = [
    (dict(dtype=torch.float16), 'bfloat16 only'),
    (dict(dtype=torch.float32), 'bfloat16 only'),
    (dict(L=24), 'L=24'), (dict(reps=3, N=4), 'reps=3'),
    (dict(Nb=3), 'bias shape'), ({}, 'CUDA device')]


@pytest.mark.parametrize('variant', list(CALLS))
@pytest.mark.parametrize('bad,match', COMMON)
def test_wrapper_rejects_what_the_kernel_does_not_take(variant, bad, match):
    with pytest.raises(ValueError, match=match):
        CALLS[variant](_meta(**bad), bad.get('reps', 1))


@pytest.mark.parametrize('variant,L,cap', [
    ('v1', 272, 256), ('v3', 272, 256), ('v4', 272, 256), ('v2', 272, 256),
    ('v1', 512, 256), ('v3', 512, 256)])
def test_wrapper_refuses_L_past_the_cap(variant, L, cap):
    """Each kernel's cap at 12 heads: S1 runs K1's attention tile (cap 256,
    K1's), S3 K1's tile with its alpha rows in shared memory (cap 256, K4's
    tile route), S2 whole K and V tiles of up to 256 keys a head (cap
    256)."""
    with pytest.raises(ValueError, match=f'L={L} is past the cap L={cap}'):
        CALLS[variant](_meta(L=L), 1)
    # The cap itself passes the shape checks (and stops only at the device).
    with pytest.raises(ValueError, match='CUDA device'):
        CALLS[variant](_meta(L=cap), 1)


@pytest.mark.parametrize('bad,match', [
    (dict(Nz=2, reps=2), 'z shape'), (dict(Cz=24), 'Cz=24'),
    (dict(Cz=8), 'Cz=8'), (dict(heads=20, L=16), 'H=20')])
def test_p2n_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        av.attention_v4(*_meta(**bad), reps=bad.get('reps', 1))


def test_shared_memory_plans():
    """The plans at the script's widths: S1's block is K1's attention tile
    in one stage up to L=128 (90,112 bytes at L=128: two blocks an SM) and
    in K1's two past it (199,680 at L=256), whatever H; S3 holds the
    gathered alpha rows of the query rows a block owns in a cluster of 8
    replica groups (16 alpha rows a z row), one replica's alpha and K1's
    one-stage tile of 64 query rows (114,688 bytes at L=128: two blocks an
    SM; 217,088 at L=256); S2 four TMA stages at L=128 (197,888) and two at
    L=256 (214,272). Every block fits in the 232,448 bytes a block may
    have, at every L each kernel takes."""
    assert (av.tile_smem(128), av.tile_smem(256)) == (90112, 199680)
    assert 2 * (av.tile_smem(128) + 1024) <= 233472
    assert av.v4_plan(256, 128, H, 64, 256) == {
        'query_rows': 64, 'threads': 128, 'rt': 2, 'cluster': (1, 1, 8),
        'rows_per_z': 16, 'smem': 114688, 'grid': (2, H, 128)}
    assert 2 * (114688 + 1024) <= 233472
    assert av.v4_plan(256, 256, H, 64, 256) == {
        'query_rows': 64, 'threads': 128, 'rt': 2, 'cluster': (1, 1, 8),
        'rows_per_z': 16, 'smem': 217088, 'grid': (4, H, 128)}
    assert av.v2_plan(256, 128, H, 256) == {
        'rt': 2, 'stages': 4, 'smem': 197888, 'threads': 384,
        'grid': (2, 128)}
    assert av.v2_plan(3, 256, H, 3) == {
        'rt': 1, 'stages': 2, 'smem': 214272, 'threads': 384,
        'grid': (4, 3)}
    for L in range(16, av.MAX_L + 1, 16):
        assert av.tile_smem(L) <= av.SMEM_BLOCK
        for reps in (1, 2, 3, 4, 256):
            assert av.v2_plan(reps, L, H, reps)['smem'] <= av.SMEM_BLOCK
            for heads, Cz in ((H, 64), (16, 64), (7, 16), (1, 48)):
                plan = av.v4_plan(reps, L, heads, Cz, reps)
                _, cy, cz = plan['cluster']
                assert plan['smem'] <= av.SMEM_BLOCK
                assert cy * cz <= av.S3_MAX_CLUSTER and heads % cy == 0
                assert (reps // plan['rt']) % cz == 0


@pytest.mark.parametrize('N,L,heads,Cz,reps', [
    (256, 128, H, 64, 256), (8, 256, H, 64, 4), (6, 144, H, 32, 3),
    (4, 48, 6, 16, 2), (2, 16, 7, 48, 1)])
def test_v4_cluster_partition(N, L, heads, Cz, reps):
    """S3's p2n rows as its blocks deal them: every (n, i, h) written
    exactly once; a cluster's blocks share one complex and one query tile;
    a block gathers only its own cluster's alpha rows (their heads and
    replicas are the cluster's)."""
    plan = av.v4_plan(N, L, heads, Cz, reps)
    qt, rt = plan['query_rows'], plan['rt']
    _, cy, cz = plan['cluster']
    seen = np.zeros((N, L, heads), np.int32)
    blocks = {}
    for cluster, (x, y, zb), n, i, h in av.v4_p2n_writes(N, L, heads, Cz,
                                                          reps):
        seen[n, i, h] += 1
        blocks.setdefault(cluster, set()).add((x, y, zb))
        assert x * qt <= i < (x + 1) * qt
        assert y - y % cy <= h < y - y % cy + cy
        assert zb - zb % cz <= n // rt < zb - zb % cz + cz
    assert (seen == 1).all()
    for members in blocks.values():
        assert len({x for x, _, _ in members}) == 1
        assert len({zb * rt // reps for _, _, zb in members}) == 1


@pytest.mark.parametrize('variant,which', [
    (v, i) for v in CALLS for i in range(5 if v == 'v4' else 4)])
def test_wrapper_raises_on_a_tensor_that_requires_grad(variant, which):
    """qa, ka, vvp, bias (and z for S3), one at a time."""
    args = [torch.from_numpy(a) for a in _operands(1, 2, 16)]
    args[which].requires_grad_()
    av.reset_counts()
    with pytest.raises(ValueError, match='requires a gradient'):
        CALLS[variant](args, 2)
    assert ia.ipa_attention_fwd_reference.calls == 0
    assert ia.ipa_attention_fwd_p2n_reference.calls == 0


@pytest.mark.parametrize('variant', list(CALLS))
def test_cpu_tensors_take_the_plain_version(variant):
    args = [torch.from_numpy(a).to(torch.bfloat16)
            for a in _operands(1, 2, 16)]
    av.reset_counts()
    got = CALLS[variant](args, 2)
    assert av.launches == {'v1': 0, 'v3': 0, 'v2': 0, 'v4': 0}
    if variant == 'v4':
        want = ia.ipa_attention_fwd_p2n_reference(*args, reps=2)
        calls = ia.ipa_attention_fwd_p2n_reference.calls
    else:
        want = ia.ipa_attention_fwd_reference(*args[:4], reps=2)
        calls = ia.ipa_attention_fwd_reference.calls
        if variant == 'v3':
            got, want = (got,), want[:1]
    assert calls == 2           # the wrapper's call and the one above
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
