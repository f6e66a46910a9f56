"""K2's and K3's launch plans and the arithmetic of K3's tensor-core tile,
on the CPU:

* ``attention_plan`` (a pure function of the shapes): the route of each
  kernel by dtype and L (16..512); on the tile route, at L 16..256 x H 4-16
  x reps 1-4, K2's grid covers every (trajectory, query row, head) once, and
  K3's covers every (trajectory, head, query row) once in its first phase
  and every (trajectory, head, key row) once in its second, its cluster
  spanning grid x; at most 232,448 bytes of shared memory a block, at most
  8 blocks a cluster;
* K3's arithmetic on the tile route, emulated in plain PyTorch (operands as
  bf16, dal, the row sums and dlog in f32, dlog into the products as bf16
  hi plus bf16 lo, f32 sums), against JAX ``_attention_bwd_call`` in
  interpret mode, at N=2, L=128, H=4 and the operand scales of
  chip_smoke.py phase 4: within the bf16 gate (1e-2 of |JAX| plus 1e-3 of
  the tensor's largest value);
* the trap that design avoids: the same emulation with dlog rounded to
  bf16 alone misses that gate (dka at 1.17x of it) on the same operands.
The kernels themselves are held against their plain versions on a card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ab_opt_tpu_torch.ops import ipa_attention as ia  # noqa: E402

GATE_RTOL, GATE_ATOL_FRAC = 1e-2, 1e-3


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plan_routes(dtype):
    """bf16 up to L=256 takes the tiles (K3 one launch), float32 and bf16
    past 256 the CUDA cores (K3 two launches); L off the 16-grid or past
    512 raises."""
    for L in range(16, 513, 16):
        plan = ia.attention_plan(dtype, 4, L, 12, 2)
        tile = dtype == torch.bfloat16 and L <= 256
        want = 'tile' if tile else 'cuda_cores'
        assert plan['fwd']['route'] == plan['bwd']['route'] == want, L
        assert len(plan['fwd']['launches']) == 1
        assert len(plan['bwd']['launches']) == (1 if tile else 2)
    for L in (8, 24, 528):
        with pytest.raises(ValueError, match=f'L={L}'):
            ia.attention_plan(dtype, 4, L, 12, 2)
    with pytest.raises(ValueError, match='dtype'):
        ia.attention_plan(torch.float16, 4, 128, 12, 2)


def _cover(length, starts, width):
    """How often each of ``length`` indices is covered by blocks starting at
    ``starts``, each ``width`` wide (clipped at the end)."""
    count = np.zeros(length + width, dtype=np.int64)
    for s0 in starts:
        count[s0:s0 + width] += 1
    return count[:length]


@pytest.mark.parametrize('reps', [1, 2, 3, 4])
@pytest.mark.parametrize('heads', [4, 6, 12, 16])
def test_tile_plan_covers_every_row_once(heads, reps):
    N = 2 * reps
    for L in range(16, 257, 16):
        plan = ia.attention_plan(torch.bfloat16, N, L, heads, reps)
        for key in ('fwd', 'bwd'):
            for launch in plan[key]['launches']:
                assert launch['smem'] <= ia.SMEM_BLOCK, (L, launch)
                assert 1 <= launch['cluster'] <= 8, (L, launch)
                assert max(launch['grid'][1:]) <= 65535, (L, launch)
        # K2: (query tile, head, replica group); rt divides reps.
        fwd = plan['fwd']
        (k2,) = fwd['launches']
        qt, rt = fwd['query_rows'], fwd['rt']
        assert reps % rt == 0 and k2['threads'] == qt // 16 * 32
        gx, gy, gz = k2['grid']
        i = _cover(L, range(0, gx * qt, qt), qt)
        h = _cover(heads, range(gy), 1)
        n = _cover(N, range(0, gz * rt, rt), rt)
        assert gx * qt - L < qt and gz * rt == N, (L, k2)
        assert (np.einsum('n,i,h->nih', n, i, h) == 1).all(), (L, k2)
        # K3: a cluster per (n, h) spans grid x; block r takes rows 64 r ..
        # as query rows, then as key rows.
        (k3,) = plan['bwd']['launches']
        rows = plan['bwd']['rows']
        gx, gy, gz = k3['grid']
        assert k3['cluster'] == gx and gx * rows - L < rows, (L, k3)
        i = _cover(L, range(0, gx * rows, rows), rows)
        cover = np.einsum('n,h,i->nhi', _cover(N, range(gz), 1),
                          _cover(heads, range(gy), 1), i)
        assert (cover == 1).all(), (L, k3)


def test_tile_plan_sizes():
    """K2's tile takes 64 query rows a block at every shape: at the
    training shape (N=16, L=128, H=12) 384 blocks, three an SM, as at 256
    replicas; past L=128 two stages. K3 fits two blocks an SM at L=128 and
    one at L=256."""
    per_sm = lambda smem: 233472 // (smem + 1024)
    plan = ia.attention_plan(torch.bfloat16, 16, 128, 12, 1)
    (k2,), (k3,) = plan['fwd']['launches'], plan['bwd']['launches']
    assert plan['fwd']['query_rows'] == 64 and k2['grid'] == (2, 12, 16)
    assert k2['threads'] == 128
    assert k2['smem'] == 63488 and per_sm(k2['smem']) == 3
    assert k3['smem'] == 110592 and per_sm(k3['smem']) == 2
    wide = ia.attention_plan(torch.bfloat16, 256, 128, 12, 256)['fwd']
    assert wide['query_rows'] == 64 and wide['rt'] == 4
    assert wide['launches'][0]['grid'] == (2, 12, 64)
    assert wide['launches'][0]['smem'] == 63488
    big = ia.attention_plan(torch.bfloat16, 4, 256, 12, 2)
    assert big['fwd']['query_rows'] == 64
    assert big['fwd']['launches'][0]['smem'] == 64 * 264 * 2 + 2 * 576 * 72 * 2
    assert per_sm(big['bwd']['launches'][0]['smem']) == 1


# ------------------------------------------------------------ arithmetic


def _k3_tile_emulation(qa, ka, vvp, alphas, dout, dalphas, split=True):
    """K3's tile arithmetic in plain PyTorch: bf16 operands, dal = dout .
    vvp^T + dalphas, tmp = dal alpha, dlog = tmp - alpha rowsum(tmp) in f32;
    dlog enters dqa = dlog . ka and dka = dlog^T . qa as bf16(dlog) plus,
    with ``split``, bf16(dlog - bf16(dlog)), summed in f32. Returns (dqa,
    dka, dvvp, dbias) in bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    N, L, HD = qa.shape
    heads = lambda a: a.reshape(N, L, HD // 64, 64).to(f32)
    alpha = alphas.to(f32)
    dal = (torch.einsum('nihd,njhd->nhij', heads(dout), heads(vvp))
           + dalphas.to(f32))
    tmp = dal * alpha
    dlog = tmp - alpha * tmp.sum(-1, keepdim=True)
    hi = dlog.to(bf16).to(f32)
    parts = (hi, (dlog - hi).to(bf16).to(f32)) if split else (hi,)
    dqa = sum(torch.einsum('nhij,njhd->nihd', p, heads(ka)) for p in parts)
    dka = sum(torch.einsum('nhij,nihd->njhd', p, heads(qa)) for p in parts)
    dvvp = torch.einsum('nhij,nihd->njhd', alpha, heads(dout))
    flat = lambda a: a.reshape(N, L, HD).to(bf16)
    return flat(dqa), flat(dka), flat(dvvp), hi.to(bf16)


@pytest.fixture(scope='module')
def bwd_case():
    """Seeded bf16 operands at N=2, L=128, H=4 (chip_smoke.py phase 4's
    scales, 5 padded key columns), alphas from the plain forward, and JAX
    ``_attention_bwd_call`` (interpret mode, jitted once) on them."""
    from ab_opt_tpu.ops.ipa_pallas import _attention_bwd_call
    N, L, H = 2, 128, 4
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(torch.bfloat16)
    qa, ka = f(N, L, H * 64, scale=0.5), f(N, L, H * 64, scale=0.5)
    vvp, dout = f(N, L, H * 64), f(N, L, H * 64)
    bias = f(N, H, L, L).float()
    bias[..., L - 5:] -= 1e5
    dalphas = f(N, H, L, L, scale=0.1)
    alphas = ia.ipa_attention_fwd_reference(qa, ka, vvp,
                                            bias.to(torch.bfloat16))[1]
    ops = (qa, ka, vvp, alphas, dout, dalphas)
    j = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    want = jax.jit(lambda *a: _attention_bwd_call(*a, interpret=True))(
        *map(j, ops))
    return ops, [torch.from_numpy(np.asarray(w, np.float32)) for w in want]


def _gate_ratio(got, want):
    """max over the tensor of |got - want| / (1e-2 |want| + 1e-3 max|want|):
    at most 1 within the bf16 gate."""
    limit = GATE_RTOL * want.abs() + GATE_ATOL_FRAC * float(want.abs().max())
    return float(((got.float() - want).abs() / limit).max())


def test_split_dlog_meets_the_gate_against_jax(bwd_case):
    ops, want = bwd_case
    got = _k3_tile_emulation(*ops)
    for name, a, b in zip(('dqa', 'dka', 'dvvp', 'dbias'), got, want):
        assert torch.isfinite(a).all(), name
        assert _gate_ratio(a, b) <= 1.0, (name, _gate_ratio(a, b))


def test_bf16_dlog_alone_misses_the_gate(bwd_case):
    """dlog's rows sum to zero, so dqa and dka cancel heavily: with dlog
    rounded to bf16 alone they leave the gate, while the split keeps both
    well inside it."""
    ops, want = bwd_case
    alone = _k3_tile_emulation(*ops, split=False)
    split = _k3_tile_emulation(*ops)
    assert max(_gate_ratio(alone[k], want[k]) for k in (0, 1)) > 1.0
    assert max(_gate_ratio(split[k], want[k]) for k in (0, 1)) < 0.75
