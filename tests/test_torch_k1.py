"""K1's pieces on the CPU: the attention launch's and the GEMM's plain
versions, the replica groups of the attention, the transposed weights of
the bundle, and the wrappers' dispatch.

* ``gablock_attention_reference`` against the attention part of the JAX
  ``_gablock_body`` (``ab_opt_tpu/ops/gablock_pallas.py:87``), the body the
  Pallas kernel runs, here run on values at a small size (L=24, F=32,
  Cz=16, H=4, 2 replicas, 3 padded rows). The body's own per-head qa/ka
  slices, value operands, softmax weights and value products are read as
  it computes them (spies on ``jax.lax.dot_general``, ``jax.nn.softmax``
  and ``jnp.dot`` for the length of the call); the port's plain attention
  then takes the same qa/ka/vv and bias. alpha within one bf16 ulp (both
  round the same f32 softmax once); o within rtol 1e-2 plus 1e-2 of the
  largest |vv| (an alpha one ulp apart moves o by up to 2^-8 of |vv|);
* ``gablock_gemm_reference`` against the layer's own GEMM steps;
* the wrappers refuse what the card kernels do not take, and CPU tensors
  take the plain versions with no launch.
The kernels themselves are held against these plain versions on a card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.ops import gablock as gb  # noqa: E402
from test_torch_gablock import _case  # noqa: E402

L_BODY, REPS_BODY = 24, 2


@pytest.fixture(scope='module')
def body_attention():
    """The JAX body's attention operands and results, captured from one
    eager call of ``_gablock_body`` on one complex with 2 replicas."""
    from ab_opt_tpu.ops import gablock_pallas as gp
    from ab_opt_tpu.ops.ipa_pallas import precompute_pair_bias as j_bias
    jblock, params, _, c = _case(1, REPS_BODY, L=L_BODY, F=32, Cz=16, H=4,
                                 n_pad=3, seed=7)
    bp = jax.tree_util.tree_map(jnp.asarray, params['params'])
    wb = gp.build_gablock_weights(bp)
    H, QK, V, P, PV = wb['dims']
    bf = jnp.bfloat16
    zb = jnp.asarray(c['z']).astype(bf)
    bias = j_bias(zb, bp['proj_pair_bias']['kernel'].astype(bf),
                  jnp.asarray(c['mask_c']), out_dtype=bf)[0]   # (H, L, L)
    rows = REPS_BODY * L_BODY
    seen = {'logits': [], 'softmax': [], 'values': []}
    dot_general, softmax, dot = jax.lax.dot_general, jax.nn.softmax, jnp.dot
    two_d = (((1,), (1,)), ((), ()))

    def spy_dot_general(a, b, dimension_numbers, **kw):
        if (dimension_numbers == two_d and a.shape == (L_BODY, 64)
                and b.shape == (L_BODY, 64)):
            seen['logits'].append((np.asarray(a), np.asarray(b)))
        return dot_general(a, b, dimension_numbers, **kw)

    def spy_softmax(a, axis=-1, **kw):
        out = softmax(a, axis=axis, **kw)
        seen['softmax'].append(np.asarray(out))
        return out

    def spy_dot(a, b, **kw):
        out = dot(a, b, **kw)
        if a.shape == (L_BODY, L_BODY) and a.dtype == bf:
            seen['values'].append((np.asarray(b), np.asarray(out)))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, 'dot_general', spy_dot_general)
    mp.setattr(jax.nn, 'softmax', spy_softmax)
    mp.setattr(jnp, 'dot', spy_dot)
    try:
        gp._gablock_body(
            jnp.asarray(c['x']).reshape(rows, -1),
            jnp.asarray(c['R']).reshape(rows, 9).astype(bf),
            jnp.asarray(c['t']).reshape(rows, 3).astype(bf),
            gp.transpose_pair_for_fused(zb)[0], bias,
            jnp.asarray(c['mask'], jnp.float32).reshape(rows, 1),
            {n: wb[n] for n in gp._W_NAMES}, RT=REPS_BODY, H=H, QK=QK, V=V,
            P=P, PV=PV, Cz=16)
    finally:
        mp.undo()
    assert len(seen['logits']) == len(seen['values']) == REPS_BODY * H
    assert len(seen['softmax']) == REPS_BODY
    per_rep = lambda pairs, i: np.stack([
        np.concatenate([p[i] for p in pairs[r * H:(r + 1) * H]], -1)
        for r in range(REPS_BODY)])                          # (reps, L, H*64)
    return {'qa': per_rep(seen['logits'], 0), 'ka': per_rep(seen['logits'], 1),
            'vv': per_rep(seen['values'], 0), 'o': per_rep(seen['values'], 1),
            'alpha': np.stack(seen['softmax']),              # (reps, H, L, L)
            'bias': np.asarray(bias)[None], 'H': H}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def test_attention_reference_matches_jax_body(body_attention):
    c = body_attention
    H, L = c['H'], L_BODY
    gb.reset_counts()
    o, alpha = gb.gablock_attention(_bf16(c['qa']), _bf16(c['ka']),
                                    _bf16(c['vv']), _bf16(c['bias']),
                                    REPS_BODY)
    assert (gb.gablock_attention_reference.calls,
            gb.gablock_attention.launches) == (1, 0)
    assert o.shape == (REPS_BODY, L, H * 64) and o.dtype == torch.bfloat16
    assert alpha.shape == (1, L, REPS_BODY * H, L)
    want_a = _bf16(c['alpha']).float().reshape(1, REPS_BODY * H, L, L)
    want_a = want_a.transpose(1, 2)
    torch.testing.assert_close(alpha.float(), want_a, rtol=2 ** -7, atol=1e-6)
    want_o = _bf16(c['o']).float()
    torch.testing.assert_close(o.float(), want_o, rtol=1e-2,
                               atol=1e-2 * float(np.abs(c['vv']).max()))
    # The padded keys (the last 3) get no weight; each row sums to one.
    assert float(alpha[..., L - 3:].float().abs().max()) < 1e-30
    torch.testing.assert_close(alpha.float().sum(-1),
                               torch.ones(1, L, REPS_BODY * H), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize('reps,rt', [(1, 1), (2, 2), (3, 1), (4, 4), (6, 2),
                                     (8, 4), (12, 4), (32, 4), (256, 4)])
def test_attention_replica_groups(reps, rt):
    """A block of K1's attention serves the largest of 4, 2, 1 replicas
    dividing reps (they share its staged bias rows)."""
    assert gb.attention_replicas(reps) == rt


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bundle_carries_the_transposed_weights(dtype):
    """K1's GEMM reads w_proj, w_out and w_m1..3 transposed, (N, K) with K
    contiguous; the (K, N) forms stay for K5 and S4."""
    _, _, tblock, _ = _case(1, 1, seed=2)
    wb = gb.build_gablock_weights(tblock, dtype)
    for name in gb.TRANSPOSED:
        wt = wb[name + '_t']
        assert wt.dtype == dtype and wt.is_contiguous()
        assert torch.equal(wt, wb[name].t())
    stacked = gb.stack_encoder_weights([wb, wb])
    assert stacked['w_proj_t'].shape == (2,) + wb['w_proj_t'].shape


def test_gemm_reference_is_the_layer_gemm():
    """The GEMM's plain version, in each of its forms, is the step the
    layer's plain version takes: bf16 operands, f32 products."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    M, K, F = 40, 96, 128
    a, w = r(M, K), r(K, F) * 0.1
    bias, resid, ln = r(F), r(M, F), r(2, F)
    mask = (r(M) > 0).float()
    mm = (a.bfloat16().float() @ w.bfloat16().float())
    gb.reset_counts()
    proj = gb.gablock_gemm(a, w.t().contiguous())
    torch.testing.assert_close(proj, mm.bfloat16(), rtol=0, atol=0)
    relu = gb.gablock_gemm(a.bfloat16(), w.t().bfloat16(), bias, relu=True)
    torch.testing.assert_close(relu, torch.relu(mm + bias).bfloat16(),
                               rtol=0, atol=0)
    got = gb.gablock_gemm(a.bfloat16(), w.t().bfloat16(), bias, resid=resid,
                          rowmask=mask, ln=ln)
    torch.testing.assert_close(
        got, gb._layernorm(resid + (mm + bias) * mask[:, None], ln),
        rtol=1e-6, atol=1e-6)
    assert (gb.gablock_gemm_reference.calls, gb.gablock_gemm.launches) == (3, 0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device='meta')


def test_attention_wrapper_refusals():
    """A tensor off the card, a wrong dtype, an L past 256 or off the
    16-row grid, and reps not dividing N raise before any launch."""
    gb.reset_counts()
    ops = lambda N=4, L=32, dt=torch.bfloat16: (
        _meta(N, L, 768, dtype=dt), _meta(N, L, 768), _meta(N, L, 768),
        _meta(N // 2, 12, L, L))
    with pytest.raises(ValueError, match='CUDA device'):
        gb.gablock_attention(*ops(), reps=2)
    with pytest.raises(ValueError, match='qa dtype'):
        gb.gablock_attention(*ops(dt=torch.float32), reps=2)
    for L in (272, 40):
        with pytest.raises(ValueError, match=f'L={L}'):
            gb.gablock_attention(*ops(L=L), reps=2)
    with pytest.raises(ValueError, match='reps=3 must divide'):
        gb.gablock_attention(*ops(), reps=3)
    assert gb.gablock_attention.launches == 0
    assert gb.gablock_attention_reference.calls == 0


def test_gemm_wrapper_refusals():
    """The projection takes f32 (M, 128) and no LayerNorm; the others bf16
    with N = 128; a tensor off the card raises."""
    f32 = torch.float32
    gb.reset_counts()
    with pytest.raises(ValueError, match='CUDA device'):
        gb.gablock_gemm(_meta(300, 128, dtype=f32), _meta(256, 128))
    with pytest.raises(ValueError, match='the projection takes'):
        gb.gablock_gemm(_meta(300, 96, dtype=f32), _meta(256, 96))
    with pytest.raises(ValueError, match='the projection takes'):
        gb.gablock_gemm(_meta(300, 96), _meta(256, 96))
    with pytest.raises(ValueError, match='no LN'):
        gb.gablock_gemm(_meta(300, 128, dtype=f32), _meta(128, 128),
                        _meta(128, dtype=f32), resid=_meta(300, 128, dtype=f32),
                        ln=_meta(2, 128, dtype=f32))
    with pytest.raises(ValueError, match='takes bias and resid'):
        gb.gablock_gemm(_meta(300, 128), _meta(128, 128),
                        ln=_meta(2, 128, dtype=f32))
    assert gb.gablock_gemm.launches == 0
