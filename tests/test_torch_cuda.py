"""The GABlock kernel (K1, its attention, p2n and GEMM launches alone too), the
IPA attention kernels (K2, K3, K4), the chained encoder kernel (K5), the
attention variants (S1-S3) and the fused-GABlock variants (S4)
against their plain versions, a float32 config's denoiser through K1 and
K5 (and through K4 past 256 residues), the design runner, the training
CLI and the graph model's loss and gradients (PyTorch ops) against the
CPU, on an NVIDIA GPU (marker
``cuda``; skips without a card). Imports no JAX, so it also runs where only
the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from ab_opt_tpu_torch.geometry import quaternion_to_rotation_matrix
from ab_opt_tpu_torch.nn.ipa import GABlock, precompute_pair_bias
from ab_opt_tpu_torch.ops import gablock as gb
from ab_opt_tpu_torch.ops import gablock_variants as gv
from ab_opt_tpu_torch.utils.bench_fixture import encoder_case


@pytest.mark.cuda
@pytest.mark.parametrize('L,Nc,reps', [(16, 1, 2), (48, 2, 3), (80, 1, 3),
                                       (128, 2, 4), (128, 2, 1), (256, 1, 4),
                                       (144, 1, 3), (128, 1, 256)])
def test_kernel_matches_plain_on_card(L, Nc, reps):
    """L below, between and at multiples of the attention's query tile (128
    rows up to L=128, 64 past it), reps 1 to 256 (attention blocks of 1, 2
    and 4 replicas), 5 padded rows; two launches are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    torch.manual_seed(0)
    H = 12
    N = Nc * reps
    block = GABlock(128, 64, num_heads=H).to(dev)
    x = torch.randn(N, L, 128, device=dev)
    R9 = quaternion_to_rotation_matrix(torch.randn(N, L, 4, device=dev)
                                       ).reshape(N, L, 9).contiguous()
    t = torch.randn(N, L, 3, device=dev)
    z = torch.randn(Nc, L, L, 64, device=dev).to(torch.bfloat16)
    mask_c = torch.ones(Nc, L, device=dev)
    mask_c[:, -5:] = 0
    with torch.no_grad():
        bias = precompute_pair_bias(z, block.proj_pair_bias.weight.t(), mask_c,
                                    torch.bfloat16)
        wb = gb.build_gablock_weights(block, torch.bfloat16)
        args = (x, R9, t, z, bias, mask_c.repeat_interleave(reps, 0), wb, reps)
        got = gb.gablock_layer(*args)
        again = gb.gablock_layer(*args)
        torch.cuda.synchronize()
        ref = gb.gablock_layer_reference(*args)
    valid = args[5] > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got[valid], ref[valid], atol=0.05, rtol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize('L', [16, 48, 128, 256])
@pytest.mark.parametrize('reps', [1, 3, 4, 256])
def test_k1_attention_matches_plain_on_card(L, reps):
    """K1's attention launch alone against its plain version, bf16, H=12,
    5 padded key columns, blocks of 1 and 4 replicas: alpha within rtol
    1e-2 plus 1e-3 of its largest value (both round the same f32 softmax
    once); o within rtol 1e-2 plus 1e-2 of the largest |vv| (an alpha one
    ulp apart moves o by up to 2^-8 of |vv|). One launch, no plain
    call."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    Nc = 2 if reps < 4 else 1
    qa, ka, vv, bias, _, _ = _attention_case(L, Nc, reps, torch.bfloat16,
                                             torch.device('cuda'),
                                             seed=L + reps)
    gb.reset_counts()
    with torch.no_grad():
        o, alpha = gb.gablock_attention(qa, ka, vv, bias, reps)
        torch.cuda.synchronize()
        assert (gb.gablock_attention.launches,
                gb.gablock_attention_reference.calls) == (1, 0)
        ref_o, ref_a = gb.gablock_attention_reference(qa, ka, vv, bias, reps)
    assert o.shape == ref_o.shape and alpha.shape == ref_a.shape
    assert torch.isfinite(o).all() and torch.isfinite(alpha).all()
    torch.testing.assert_close(alpha.float(), ref_a.float(), rtol=1e-2,
                               atol=1e-3 * float(ref_a.float().abs().max()))
    torch.testing.assert_close(o.float(), ref_o.float(), rtol=1e-2,
                               atol=1e-2 * float(vv.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('M', [64, 300, 4096])
@pytest.mark.parametrize('form', ['proj', 'relu', 'ln_out', 'ln_mlp'])
def test_k1_gemm_matches_plain_on_card(M, form):
    """K1's GEMM alone against its plain version in each of its forms: the
    projection (f32 x, 2048 columns), MLP1/2 (bias, ReLU), out_transform
    (K = 1824) and MLP3 (K = 128) with the LayerNorm epilogue, row mask
    zeros on a third of the rows; M at, past and far past the 64- and
    128-row tiles. bf16 outputs within one bf16 ulp of the plain version
    (rtol 1e-2, atol 1e-2 of the largest value); the LN outputs within
    1e-3."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(M)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    bf16 = torch.bfloat16
    K = {'proj': 128, 'relu': 128, 'ln_out': 1824, 'ln_mlp': 128}[form]
    N = 2048 if form == 'proj' else 128
    a = r(M, K) if form == 'proj' else r(M, K).to(bf16)
    w_t = (r(N, K) / K ** 0.5).to(bf16)
    kw = {}
    if form == 'relu':
        kw = dict(bias=r(N), relu=True)
    elif form != 'proj':
        kw = dict(bias=r(N), resid=r(M, N), rowmask=(r(M) > -0.4).float(),
                  ln=r(2, N))
    gb.reset_counts()
    with torch.no_grad():
        got = gb.gablock_gemm(a, w_t, **kw)
        torch.cuda.synchronize()
        assert (gb.gablock_gemm.launches, gb.gablock_gemm_reference.calls) == (
            1, 0)
        ref = gb.gablock_gemm_reference(a, w_t, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    if 'ln' in kw:
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2,
                                   atol=1e-2 * float(ref.float().abs().max()))


def _attention_case(L, Nc, reps, dtype, dev, H=12, n_pad=5, seed=0):
    """Seeded K2/K3 operands (made on the CPU, moved to ``dev``)."""
    from ab_opt_tpu_torch.ops.ipa_attention import SLOT
    g = torch.Generator().manual_seed(seed)
    N = Nc * reps
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
    qa, ka, vvp, dout = (r(N, L, H * SLOT, scale=s) for s in (0.5, 0.5, 1, 1))
    bias = r(Nc, H, L, L)
    bias[..., L - n_pad:] -= 1e5            # padded key columns
    dalphas = r(N, H, L, L, scale=0.1)
    to = lambda a: a.to(dev, dtype).contiguous()
    return tuple(map(to, (qa, ka, vvp, bias, dout, dalphas)))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('L,Nc,reps', [(16, 2, 1), (48, 1, 2), (128, 2, 1),
                                       (512, 1, 2)])
def test_attention_kernels_match_plain_on_card(L, Nc, reps, dtype):
    """K2 (out, alphas) and K3 (dqa, dka, dvvp, dbias) against their plain
    versions: atol/rtol 1e-3 in float32. Both sides compute in f32 and round
    each output once, so in bf16 they differ by about one ulp (2^-7
    relative): rtol 1e-2 and atol 1e-3 of the tensor's largest value."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    qa, ka, vvp, bias, dout, dalphas = _attention_case(
        L, Nc, reps, dtype, torch.device('cuda'))
    got = ia.ipa_attention_fwd(qa, ka, vvp, bias, reps)
    got += ia.ipa_attention_bwd(qa, ka, vvp, got[1], dout, dalphas)
    torch.cuda.synchronize()
    ref = ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
    ref += ia.ipa_attention_bwd_reference(qa, ka, vvp, got[1], dout, dalphas)
    names = ('out', 'alphas', 'dqa', 'dka', 'dvvp', 'dbias')
    for name, a, b in zip(names, got, ref):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        b = b.float()
        if dtype == torch.float32:
            atol = rtol = 1e-3
        else:
            atol, rtol = 1e-3 * float(b.abs().max()), 1e-2
        torch.testing.assert_close(a.float(), b, atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_attention():
    """Forward and backward through the autograd function on CUDA tensors
    launch K2 and K3 once each and call no plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    qa, ka, vvp, bias, dout, dalphas = _attention_case(
        64, 2, 2, torch.bfloat16, torch.device('cuda'))
    leaves = [a.requires_grad_() for a in (qa, ka, vvp, bias)]
    ia.reset_counts()
    out, alphas = ia.ipa_attention(*leaves, reps=2)
    ((out.float() * dout.float()).sum()
     + (alphas.float() * dalphas.float()).sum()).backward()
    torch.cuda.synchronize()
    assert (ia.ipa_attention_fwd.launches, ia.ipa_attention_bwd.launches) == (1, 1)
    assert ia.ipa_attention_fwd_reference.calls == 0
    assert ia.ipa_attention_bwd_reference.calls == 0
    assert all(torch.isfinite(a.grad).all() for a in leaves)
    assert bias.grad.shape == bias.shape


def _gate(name, a, b, dtype):
    """K2/K3's gates: atol/rtol 1e-3 in float32; in bf16 rtol 1e-2 and atol
    1e-3 of the plain tensor's largest value."""
    assert a.dtype == dtype and a.shape == b.shape, name
    assert torch.isfinite(a).all(), name
    b = b.float()
    if dtype == torch.float32:
        atol = rtol = 1e-3
    else:
        atol, rtol = 1e-3 * float(b.abs().max()), 1e-2
    torch.testing.assert_close(a.float(), b, atol=atol, rtol=rtol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('L', [16, 48, 128, 256, 512])
def test_attention_routes_match_plain_on_card(L, dtype):
    """K2 and K3 on the route attention_plan names (bf16 up to L=256: the
    tiles, K3 one launch of a cluster; float32 and L=512: the CUDA cores),
    reps 2, 5 padded key columns: out and alphas, then dqa, dka, dvvp and
    the per-trajectory dbias from the kernel's alphas, against the plain
    versions (K2/K3's gates); through IPAAttention the same gradients, dbias
    summed over the replicas; each kernel launched twice, bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    Nc, reps, H = 2, 2, 12
    qa, ka, vvp, bias, dout, dalphas = _attention_case(
        L, Nc, reps, dtype, torch.device('cuda'), seed=L + 1)
    plan = ia.attention_plan(dtype, Nc * reps, L, H, reps)
    assert plan['fwd']['route'] == plan['bwd']['route'] == (
        'tile' if dtype == torch.bfloat16 and L <= 256 else 'cuda_cores')
    ia.reset_counts()
    with torch.no_grad():
        fwd = [ia.ipa_attention_fwd(qa, ka, vvp, bias, reps) for _ in range(2)]
        bwd = [ia.ipa_attention_bwd(qa, ka, vvp, fwd[0][1], dout, dalphas)
               for _ in range(2)]
        torch.cuda.synchronize()
        ref = ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
        ref += ia.ipa_attention_bwd_reference(qa, ka, vvp, fwd[0][1], dout,
                                              dalphas)
    assert (ia.ipa_attention_fwd.launches, ia.ipa_attention_bwd.launches) == (2, 2)
    names = ('out', 'alphas', 'dqa', 'dka', 'dvvp', 'dbias')
    for name, a, again, b in zip(names, fwd[0] + bwd[0], fwd[1] + bwd[1], ref):
        _gate(name, a, b, dtype)
        assert torch.equal(a, again), name
    leaves = [a.clone().requires_grad_() for a in (qa, ka, vvp, bias)]
    out, alphas = ia.ipa_attention(*leaves, reps=reps)
    torch.autograd.backward((out, alphas), (dout, dalphas))
    torch.cuda.synchronize()
    assert ia.ipa_attention_fwd_reference.calls == 1
    assert ia.ipa_attention_bwd_reference.calls == 1
    assert torch.equal(out, fwd[0][0]) and torch.equal(alphas, fwd[0][1])
    for leaf, want in zip(leaves[:3], bwd[0][:3]):
        assert torch.equal(leaf.grad, want)
    assert torch.equal(leaves[3].grad,
                       bwd[0][3].reshape(Nc, reps, H, L, L).sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize('L', [16, 48, 128, 144, 256])
@pytest.mark.parametrize('reps', [1, 3, 4])
def test_k2_tile_is_s1_v1_bitwise_on_card(L, reps):
    """K2's tile (64 query rows a block) computes out and alphas bit for bit
    as S1 v1 (128 query rows a block up to L=128) on the same operands: a
    plan changes no warp's sums."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    Nc = 2 if reps < 4 else 1
    qa, ka, vvp, bias, _, _ = _attention_case(L, Nc, reps, torch.bfloat16,
                                              torch.device('cuda'),
                                              seed=L + reps)
    with torch.no_grad():
        want = av.attention_v1(qa, ka, vvp, bias, reps)
        got = ia.ipa_attention_fwd(qa, ka, vvp, bias, reps)
        torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_attention_plan_is_the_sources_on_card():
    """attention_plan's routes, grids, threads, clusters and shared memory
    are the source's own at every L for both types, H 4-20 and reps
    1-256."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    for dtype in (torch.float32, torch.bfloat16):
        for L in range(16, ia.MAX_L + 1, 16):
            for H, reps in ((4, 1), (12, 2), (6, 3), (20, 4), (12, 256)):
                N = 4 * reps
                want = ia.plan_launches(ia.attention_plan(dtype, N, L, H, reps))
                got = ia.source_attention_plan(N, L, H, reps, dtype)
                assert got == want, (dtype, L, H, reps)


@pytest.mark.cuda
def test_p2n_odd_heads_and_width_match_plain_on_card():
    """K4 in bf16 at H=6, Cz=32 (L=128, reps 2, 5 padded key columns), a
    shape the tile does not take, runs on the CUDA-core route and meets the
    bf16 gate against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    dev = torch.device('cuda')
    qa, ka, vvp, bias, _, _ = _attention_case(128, 1, 2, torch.bfloat16, dev,
                                              H=6, seed=6)
    g = torch.Generator().manual_seed(32)
    z = torch.randn(1, 128, 128, 32, generator=g).to(dev, torch.bfloat16)
    assert ia.fwd_p2n_plan(torch.bfloat16, 2, 128, 6, 32, 2)['route'] == (
        'cuda_cores')
    ia.reset_counts()
    with torch.no_grad():
        got = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, 2)
        torch.cuda.synchronize()
        ref = ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, 2)
    assert ia.ipa_attention_fwd_p2n.launches == 1
    assert ia.ipa_attention_fwd_p2n_reference.calls == 1
    for name, a, b in zip(('out', 'p2n'), got, ref):
        _gate(name, a, b, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('L,Nc,reps', [(16, 2, 1), (48, 1, 3), (128, 2, 2),
                                       (256, 1, 2), (512, 1, 2)])
def test_p2n_kernel_matches_plain_on_card(L, Nc, reps, dtype):
    """K4 (out, p2n) against its plain version at the IPA widths (H=12,
    Cz=64), reps 1, 2 and 3, with padded key columns; at L=16 and 48 the
    float32 kernel's 32-row query tile runs past L (padded rows); bf16 up
    to L=256 takes the tensor-core variant, L=512 the CUDA-core one:
    atol/rtol 1e-3 in float32; in bf16 both round each output once, rtol
    1e-2 and atol 1e-3 of the tensor's largest value."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    dev = torch.device('cuda')
    qa, ka, vvp, bias, _, _ = _attention_case(L, Nc, reps, dtype, dev,
                                              seed=L + reps)
    g = torch.Generator().manual_seed(L)
    z = torch.randn(Nc, L, L, 64, generator=g).to(dev, dtype).contiguous()
    ia.reset_counts()
    got = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)
    torch.cuda.synchronize()
    assert ia.ipa_attention_fwd_p2n.launches == 1
    ref = ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps)
    for name, a, b in zip(('out', 'p2n'), got, ref):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        b = b.float()
        if dtype == torch.float32:
            atol = rtol = 1e-3
        else:
            atol, rtol = 1e-3 * float(b.abs().max()), 1e-2
        torch.testing.assert_close(a.float(), b, atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('L', [16, 48, 128, 144, 256])
@pytest.mark.parametrize('reps', [1, 2, 3, 4, 256])
def test_p2n_tile_matches_k1_and_plain_on_card(L, reps):
    """K4's tile route (bf16, H=12, Cz=64, 5 padded key columns): o bitwise
    equal to K1's attention launch on the same operands and p2n to K1's p2n
    launch on K1's alpha (the same tiles and sums), p2n within the bf16 gate
    (rtol 1e-2 plus 1e-3 of its largest value) of the plain version; two
    launches bitwise equal. One count a call, no plain call."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    dev = torch.device('cuda')
    Nc = 2 if reps < 4 else 1
    qa, ka, vvp, bias, _, _ = _attention_case(L, Nc, reps, torch.bfloat16,
                                              dev, seed=L + reps)
    g = torch.Generator().manual_seed(L + 7)
    z = torch.randn(Nc, L, L, 64, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        o_k1, alpha_k1 = gb.gablock_attention(qa, ka, vvp, bias, reps)
        p2n_k1 = gb.gablock_p2n(alpha_k1, z, reps)
        ref = ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps)
        assert ia.fwd_p2n_plan(torch.bfloat16, Nc * reps, L, 12, 64,
                               reps)['route'] == 'tile'
        ia.reset_counts()
        got = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)
        again = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)
        torch.cuda.synchronize()
    assert ia.ipa_attention_fwd_p2n.launches == 2
    assert ia.ipa_attention_fwd_p2n_reference.calls == 0
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[0], o_k1) and torch.equal(got[1], p2n_k1)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        b = b.float()
        torch.testing.assert_close(a.float(), b, rtol=1e-2,
                                   atol=1e-3 * float(b.abs().max()))


@pytest.mark.cuda
def test_p2n_plan_is_the_sources_on_card():
    """The wrapper's plan is the source's at every L (the tile route's
    shared memory, query rows and stages; the CUDA-core route's query rows),
    and a shape no route takes raises on CUDA tensors with no launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    for L in range(16, 257, 16):
        plan = ia.fwd_p2n_plan(torch.bfloat16, 8, L, 12, 64, 4)
        want = ([launch['smem'] for launch in plan['launches']]
                + [plan['query_rows'], plan['p2n_stages']])
        assert ia.source_plan(L) == want, L
    lib = ia._library()
    for L in range(16, ia.MAX_L + 1, 16):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            if not (L <= ia.TILE_MAX_L and code):
                plan = ia.fwd_p2n_plan(dtype, 8, L, 12, 64, 4)
                assert (lib.ipa_attention_fwd_p2n_tile(L, 12, code)
                        == plan['query_rows']), (L, dtype)
    dev = torch.device('cuda')
    qa, ka, vvp, bias, _, _ = _attention_case(128, 1, 2, torch.bfloat16, dev)
    ia.reset_counts()
    with pytest.raises(ValueError, match='Cz=80'):
        ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, torch.zeros(
            1, 128, 128, 80, dtype=torch.bfloat16, device=dev), 2)
    assert ia.ipa_attention_fwd_p2n.launches == 0


# K5's card cases: L 16, 48, 128 and 256 (the attention tile's 128 rows
# below, at and past L), reps 1, 2, 3, 4, 32 and 256 (attention groups of 1,
# 2 and 4 replicas; one to 24 alpha-row blocks of a p2n item), padded rows,
# 2 and 6 distinct layers.
CHAIN_CASES = [
    (16, 2, 1, 6, 3), (48, 1, 3, 2, 5), (128, 2, 2, 6, 8), (128, 1, 1, 2, 0),
    (256, 1, 3, 2, 7), (256, 2, 2, 6, 0), (128, 1, 4, 6, 5),
    (128, 1, 32, 6, 0), (128, 1, 256, 2, 0), (256, 1, 4, 2, 3),
    (48, 2, 32, 2, 4), (16, 1, 256, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize('L,Nc,reps,layers,n_pad', CHAIN_CASES)
def test_chain_kernel_matches_plain_and_k1_on_card(L, Nc, reps, layers, n_pad):
    """K5 against ``layers`` K1 launches on the same inputs within 0.005 (it
    runs K1's tiles) and against the plain chain within atol/rtol 0.05 (K1's
    budget), on valid rows, distinct weights per layer (a layer-stride fault
    shows); a second launch on the same counters is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    args, bundles, biases = encoder_case(L, Nc, reps, layers, n_pad,
                                         torch.device('cuda'), seed=L + reps)
    _, _, R9, t, x, z, _, mask, _ = args
    gb.reset_counts()
    with torch.no_grad():
        got = gb.fused_encoder_chained(*args)
        again = gb.fused_encoder_chained(*args)
        k1 = x
        for wb, bias in zip(bundles, biases):
            k1 = gb.gablock_layer(k1, R9, t, z, bias, mask, wb, reps)
        torch.cuda.synchronize()
        ref = gb.fused_encoder_chained_reference(*args)
    assert gb.fused_encoder_chained.launches == 2
    assert gb.gablock_layer.launches == layers
    assert gb.fused_encoder_chained_reference.calls == 1
    valid = mask > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got[valid], k1[valid], atol=0.005, rtol=0)
    torch.testing.assert_close(got[valid], ref[valid], atol=0.05, rtol=0.05)


@pytest.mark.cuda
def test_chain_kernel_is_one_launch_a_pass():
    """Under torch.profiler one pass (after a warm-up that builds the plan
    and the workspace) is exactly one device kernel: no memset, no helper."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args, _, _ = encoder_case(128, 1, 32, 6, 0, torch.device('cuda'))
    with torch.no_grad():
        gb.fused_encoder_chained(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gb.fused_encoder_chained(*args)
            torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert 'chain_kernel' in kernels[0][0]


@pytest.mark.cuda
def test_chain_kernel_rejects_what_it_does_not_take():
    """L past 256 raises and nothing launches, as K1 refuses it; H=20 at
    L=256, which PR 4's shared-memory layout refused, runs and matches the
    plain chain."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    dev = torch.device('cuda')
    gb.reset_counts()
    args, _, _ = encoder_case(272, 1, 1, 2, 0, dev)
    with pytest.raises(ValueError, match='L=272'):
        gb.fused_encoder_chained(*args)
    assert gb.fused_encoder_chained.launches == 0
    args, _, _ = encoder_case(256, 1, 1, 2, 0, dev, H=20)
    with torch.no_grad():
        got = gb.fused_encoder_chained(*args)
        torch.cuda.synchronize()
        ref = gb.fused_encoder_chained_reference(*args)
    assert gb.fused_encoder_chained.launches == 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=0.05, rtol=0.05)


VARIANT_CASES = [(v, L, Nc, reps) for v in ('v1', 'v3', 'v2', 'v4')
                 for L, Nc, reps in ((16, 2, 1), (48, 1, 3), (128, 2, 1),
                                     (128, 1, 3))]
VARIANT_CASES += [('v2', 192, 1, 3)]         # S2: three 64-key chunks
# A ragged query tile (L=144: 64-row tiles for S1 and S3, a 64-key chunk
# of zero-filled keys for S2) and the cap, in blocks of 1, 2 and 4
# replicas.
VARIANT_CASES += [(v, L, Nc, reps) for v in ('v1', 'v3', 'v2', 'v4')
                  for L, Nc, reps in ((144, 1, 3), (256, 1, 4), (256, 2, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize('variant,L,Nc,reps', VARIANT_CASES)
def test_attention_variants_match_plain_on_card(variant, L, Nc, reps):
    """S1 (v1, v3), S2 (v2) and S3 (v4) against their plain versions (K2's
    and K4's), bf16, 5 padded key columns, L up to the cap 256: each
    tensor within rtol 1e-2 and atol 1e-3 of its largest value (both
    sides compute in f32 and round alpha and each output once). The call
    launches its kernel once and reaches no plain version; a second call
    is bitwise equal to the first."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.utils.micro_attention import make_operands
    qa, ka, vvp, bias, z = make_operands(Nc * reps, reps, L, 12, 64,
                                         torch.device('cuda'), seed=L + reps,
                                         n_pad=5)

    def call():
        if variant == 'v4':
            return av.attention_v4(qa, ka, vvp, bias, z, reps)
        if variant == 'v2':
            return av.attention_v2(qa, ka, vvp, bias, reps)
        got = av.attention_v1(qa, ka, vvp, bias, reps,
                              store_alphas=variant == 'v1')
        return got if variant == 'v1' else (got,)

    av.reset_counts()
    with torch.no_grad():
        got = call()
        torch.cuda.synchronize()
        assert ia.ipa_attention_fwd_reference.calls == 0
        assert ia.ipa_attention_fwd_p2n_reference.calls == 0
        assert av.launches == {k: int(k == variant) for k in av.launches}
        again = call()
        ref = (ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps)
               if variant == 'v4'
               else ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps))
    for a, a2, b in zip(got, again, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.isfinite(a).all()
        assert torch.equal(a, a2)
        b = b.float()
        torch.testing.assert_close(a.float(), b, rtol=1e-2,
                                   atol=1e-3 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('L,Nc,reps', [(16, 2, 1), (48, 1, 3), (128, 1, 256),
                                       (144, 1, 3), (256, 2, 2), (256, 1, 8)])
def test_v4_is_k4_bitwise_on_card(L, Nc, reps):
    """S3 runs K4's attention tile and p2n products (H=12, Cz=64: K4's tile
    route) in one launch: o and p2n equal K4's bit for bit; S2's out and
    alphas stay within the bf16 gate of S1 v1's (another summation order
    on wgmma)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.utils.micro_attention import make_operands
    qa, ka, vvp, bias, z = make_operands(Nc * reps, reps, L, 12, 64,
                                         torch.device('cuda'), seed=L + 7,
                                         n_pad=3)
    assert ia.fwd_p2n_plan(torch.bfloat16, Nc * reps, L, 12, 64,
                           reps)['route'] == 'tile'
    with torch.no_grad():
        got = av.attention_v4(qa, ka, vvp, bias, z, reps)
        want = ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps)
        s2 = av.attention_v2(qa, ka, vvp, bias, reps)
        s1 = av.attention_v1(qa, ka, vvp, bias, reps)
        torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(s2, s1):
        b = b.float()
        torch.testing.assert_close(a.float(), b, rtol=1e-2,
                                   atol=1e-3 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('variant', ['v2', 'v4'])
@pytest.mark.parametrize('H,Cz,L,Nc,reps', [
    (7, 16, 48, 1, 3), (16, 32, 144, 2, 2), (5, 48, 80, 1, 1),
    (1, 64, 256, 2, 1)])
def test_attention_variants_odd_shapes_on_card(variant, H, Cz, L, Nc, reps):
    """S2 and S3 at shapes off the script's: H from 1 to 16 (S2's head
    loop with an odd number of items; S3's clusters over heads as well as
    replica groups), Cz 16-64 (S3), L between 64-key chunks (S2's masked
    keys) and odd reps (S2 one replica a block), 5 padded key columns,
    against their plain versions under the bf16 gate."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.utils.micro_attention import make_operands
    qa, ka, vvp, bias, z = make_operands(Nc * reps, reps, L, H, Cz,
                                         torch.device('cuda'), seed=H + L,
                                         n_pad=5)
    with torch.no_grad():
        if variant == 'v4':
            got = av.attention_v4(qa, ka, vvp, bias, z, reps)
            ref = ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z,
                                                     reps)
        else:
            got = av.attention_v2(qa, ka, vvp, bias, reps)
            ref = ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
        torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.isfinite(a).all()
        b = b.float()
        torch.testing.assert_close(a.float(), b, rtol=1e-2,
                                   atol=1e-3 * float(b.abs().max()))


@pytest.mark.cuda
def test_attention_variants_refuse_on_card():
    """float32 and an L past the cap raise on CUDA tensors and launch
    nothing (every variant past 256); the wrappers' plans (S1's shared
    memory, S2's and S3's whole plans) are the source's."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    from ab_opt_tpu_torch.ops import attention_variants as av
    from ab_opt_tpu_torch.utils.micro_attention import make_operands
    dev = torch.device('cuda')
    lib = av._library()
    for L in (16, 48, 128, 144, 192, 208, 256):
        assert lib.attention_tile_smem(L) == av.tile_smem(L)
        for reps in (1, 3, 4, 256):
            assert (av.source_v2_plan(reps, L, 12, reps)
                    == av.v2_plan(reps, L, 12, reps))
            for H, Cz in ((12, 64), (16, 32), (7, 16)):
                assert (av.source_v4_plan(reps, L, H, Cz, reps)
                        == av.v4_plan(reps, L, H, Cz, reps))
    av.reset_counts()
    qa, ka, vvp, bias, z = make_operands(2, 1, 32, 12, 64, dev)
    f32 = [a.float() for a in (qa, ka, vvp, bias, z)]
    with pytest.raises(ValueError, match='bfloat16 only'):
        av.attention_v1(*f32[:4])
    with pytest.raises(ValueError, match='bfloat16 only'):
        av.attention_v2(*f32[:4])
    with pytest.raises(ValueError, match='bfloat16 only'):
        av.attention_v4(*f32)
    qa, ka, vvp, bias, z = make_operands(1, 1, 272, 12, 64, dev)
    for call in (lambda: av.attention_v2(qa, ka, vvp, bias),
                 lambda: av.attention_v4(qa, ka, vvp, bias, z),
                 lambda: av.attention_v1(qa, ka, vvp, bias),
                 lambda: av.attention_v1(qa, ka, vvp, bias,
                                         store_alphas=False)):
        with pytest.raises(ValueError, match='past the cap L=256'):
            call()
    assert av.launches == {'v1': 0, 'v3': 0, 'v2': 0, 'v4': 0}


def _gablock_case(L, Nc, reps, n_pad=5):
    """One seeded GABlock layer at the sampler's widths (H=12), n_pad
    padded rows a complex: the arguments of gablock_layer."""
    from ab_opt_tpu_torch.utils.micro_fused import make_case
    return make_case(Nc, reps, L, torch.device('cuda'), n_pad=n_pad,
                     seed=L + reps)


@pytest.mark.cuda
@pytest.mark.parametrize('L,Nc,reps,rt', [
    (L, Nc, reps, rt) for L in (16, 48, 128) for Nc, reps, rt in
    ((2, 4, 2), (1, 8, 4), (1, 8, 1), (1, 8, 8))])
def test_gablock_v3_matches_plain_on_card(L, Nc, reps, rt):
    """S4's v3 (K1's launches, the attention over rt replicas) against
    K1's plain version, bf16, 5 padded rows a complex, atol/rtol 0.05 on
    valid rows; one v3 launch, no K1 launch and no plain call. It equals
    K1 (which takes its own rt) and the abl baseline (mask 0) bit for bit:
    grouping replicas into blocks changes no sum."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    args = _gablock_case(L, Nc, reps)
    gv.reset_counts()
    gb.reset_counts()
    with torch.no_grad():
        got = gv.gablock_layer_v3(*args, rt=rt)
        torch.cuda.synchronize()
        assert (gv.launches, gb.gablock_layer.launches) == (
            {'v3': 1, 'abl': 0}, 0)
        assert gb.gablock_layer_reference.calls == 0
        ref = gb.gablock_layer_reference(*args)
        assert torch.equal(got, gb.gablock_layer(*args))
        assert torch.equal(got, gv.gablock_layer_abl(*args))
    valid = args[5] > 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[valid], ref[valid], atol=0.05, rtol=0.05)


def _ablation_matches_plain(args, flags):
    gv.reset_counts()
    with torch.no_grad():
        got = gv.gablock_layer_abl(*args, flags=flags)
        torch.cuda.synchronize()
        assert gv.launches == {'v3': 0, 'abl': 1}
        assert gv.gablock_layer_abl_reference.calls == 0
        ref = gv.gablock_layer_abl_reference(*args, flags=flags)
    valid = args[5] > 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[valid], ref[valid], atol=0.05, rtol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize('flags', gv.ABLATIONS,
                         ids=lambda f: f[0] if len(f) == 1 else 'floor')
def test_gablock_ablations_match_plain_on_card(flags):
    """Each ablation mask of S4 against the plain version with the same
    flags at L=48 (2 complexes x 3 replicas, 5 padded rows), atol/rtol 0.05
    on valid rows; one abl launch and no plain call."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    _ablation_matches_plain(_gablock_case(48, 2, 3), flags)


@pytest.mark.cuda
@pytest.mark.parametrize('L', [128, 256])
@pytest.mark.parametrize('flags', [()] + list(gv.ABLATIONS),
                         ids=lambda f: f[0] if len(f) == 1 else
                         'floor' if f else 'none')
def test_gablock_ablations_on_both_attention_plans_on_card(L, flags):
    """Every mask of S4 (none, each flag, the floor) against its plain
    version on each of K1's attention plans: L=128 (128 query rows, three
    stages) and L=256 (64 rows, two stages), one complex of 4 replicas (one
    replica group), 5 padded rows, atol/rtol 0.05 on valid rows."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    _ablation_matches_plain(_gablock_case(L, 1, 4), flags)


@pytest.mark.cuda
@pytest.mark.parametrize('Nc,reps,n_pad,L', [
    (1, 32, 0, 128), (2, 4, 8, 128), (1, 256, 0, 128), (2, 3, 5, 48),
    (1, 4, 0, 256), (2, 1, 3, 128)])
def test_gablock_abl_baseline_is_k1_bitwise_on_card(Nc, reps, n_pad, L):
    """The abl baseline (mask 0) is K1 bit for bit at K1's checked shapes
    (chip_smoke.py's K1_CASES: reps 1 to 256, ragged query tiles, padded
    rows, both attention plans)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    args = _gablock_case(L, Nc, reps, n_pad)
    with torch.no_grad():
        assert torch.equal(gv.gablock_layer_abl(*args),
                           gb.gablock_layer(*args))


@pytest.mark.cuda
def test_gablock_variant_refusals_on_card():
    """A flag set without a mask and an rt that does not divide reps raise
    and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    args = _gablock_case(16, 1, 4)
    gv.reset_counts()
    with pytest.raises(ValueError, match='the kernel takes none'):
        gv.gablock_layer_abl(*args, flags=('skip_rot', 'skip_sq'))
    with pytest.raises(ValueError, match='rt=3 must divide'):
        gv.gablock_layer_v3(*args, rt=3)
    assert gv.launches == {'v3': 0, 'abl': 0}


def _f32_denoiser(route, monkeypatch, L=64, reps=4):
    """One denoiser evaluation of a float32 DiffAbConfig() model (full
    widths, six layers) through K1 (``route='k1'``) or K5 (``'k5'``) and
    through the same route's plain version, on one synthetic complex;
    returns both outputs and the kernel's launches."""
    import numpy as np
    from ab_opt_tpu_torch.geometry import rotation_to_so3vec
    from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    if route == 'k5':
        monkeypatch.setenv('AB_OPT_FUSED_CHAIN', '1')
        plain = {'chain': gb.fused_encoder_chained_reference}
    else:
        monkeypatch.delenv('AB_OPT_FUSED_CHAIN', raising=False)
        plain = {'layer': gb.gablock_layer_reference}
    dev = torch.device('cuda')
    torch.manual_seed(0)
    model = DiffAb(DiffAbConfig()).to(dev)
    assert model.cfg.dtype == 'float32'
    batch = synthetic_batch(np.random.default_rng(0), N=1, L=L, n_ab=40,
                            gen_lo=16, gen_hi=24, device=dev)
    rep = lambda a: a.repeat_interleave(reps, 0)
    gb.reset_counts()
    outs = []
    with torch.no_grad():
        res_feat, pair_feat, R0, p0 = model.encode(batch, True, True)
        gen, mres = rep(batch['generate_flag']), rep(batch['mask'])
        v = rotation_to_so3vec(rep(R0))
        p = model.normalize_position(rep(p0))
        beta = torch.full((reps,), 0.05, device=dev)
        for kw in ({}, plain):
            enc, hw = model.prepare_denoiser(pair_feat, mres, reps, **kw)
            outs.append(model.eps_net(v, p, rep(batch['aa']), rep(res_feat),
                                      pair_feat, beta, gen, mres, reps=reps,
                                      encoder_fn=enc, head_weights=hw))
    torch.cuda.synchronize()
    launches = (gb.fused_encoder_chained.launches if route == 'k5'
                else gb.gablock_layer.launches)
    return outs, launches


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['k1', 'k5'])
def test_float32_config_denoiser_on_card(route, monkeypatch):
    """A float32 config's sampler takes K1/K5 with bf16 operands (the JAX
    kernel route's): the denoiser through the kernel within 0.03 of the
    same route's plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    (got, want), launches = _f32_denoiser(route, monkeypatch)
    assert launches == (1 if route == 'k5' else 6)
    for i in (1, 2, 3):   # R_next, eps_pos, c_denoised
        assert torch.isfinite(got[i]).all()
        assert float((got[i].float() - want[i].float()).abs().max()) < 0.03


@pytest.mark.cuda
def test_design_runner_on_card(tmp_path):
    """design_for_pdb on the card at full widths, two layers and four steps
    (docking crop, L=32): the runner's file tree, finite scores, and K1 at
    steps x layers launches a sampler call."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    import math
    import os
    from ab_opt_tpu_torch.runners.design import DesignArgs, design_for_pdb
    from ab_opt_tpu_torch.utils.bench_fixture import write_synthetic_complex
    pdb = write_synthetic_complex(str(tmp_path / 'cx.pdb'))
    cfg = {'mode': 'single_cdr',
           'sampling': {'cdrs': ['H_CDR3'], 'sample_structure': True,
                        'sample_sequence': True},
           'model': {'initial_patch_size': 0, 'antigen_size': 20,
                     'remove_anchor': True,
                     'diffusion': {'num_steps': 4,
                                   'eps_net_opt': {'num_layers': 2}}}}
    gb.reset_counts()
    res = design_for_pdb(DesignArgs(pdb_path=pdb, config=cfg, num_samples=6,
                                    batch_size=4, topk=2,
                                    out_root=str(tmp_path / 'out')))
    assert gb.gablock_layer.launches == 2 * 4 * 2
    assert gb.gablock_layer_reference.calls == 0
    summ = res['H_CDR3']
    for k in ('DockQ_mean', 'AAR_mean', 'prmsd_mean', 'irms_mean'):
        assert math.isfinite(summ[k]), k
    out = tmp_path / 'out' / 'cx.pdb'
    for f in ('H_CDR3/REF1.pdb', 'H_CDR3/0000.pdb', 'H_CDR3/0005.pdb',
              'results.csv', 'aa.csv', 'traj.pdb'):
        assert os.path.exists(out / f), f
    assert (out / 'traj.pdb').read_text().count('MODEL ') == 4


@pytest.mark.cuda
def test_auto_route_past_256_takes_k4_on_card():
    """A float32 config's ``'auto'`` sampler at L=320 takes K4's route (the
    eager GAEncoder over K4's CUDA-core tiles): one K4 launch a layer and
    no K1 or K5 launch a denoiser evaluation, within 0.01 of the same
    evaluation through K4's plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    import numpy as np
    from ab_opt_tpu_torch.geometry import rotation_to_so3vec
    from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    dev, L, reps = torch.device('cuda'), 320, 2
    torch.manual_seed(0)
    model = DiffAb(DiffAbConfig()).to(dev)
    batch = synthetic_batch(np.random.default_rng(0), N=1, L=L, n_ab=200,
                            gen_lo=90, gen_hi=100, device=dev)
    rep = lambda a: a.repeat_interleave(reps, 0)
    gb.reset_counts()
    ia.reset_counts()
    outs = []
    with torch.no_grad():
        res_feat, pair_feat, R0, p0 = model.encode(batch, True, True)
        gen, mres = rep(batch['generate_flag']), rep(batch['mask'])
        v = rotation_to_so3vec(rep(R0))
        p = model.normalize_position(rep(p0))
        beta = torch.full((reps,), 0.05, device=dev)
        for kw in ({}, {'attention': ia.ipa_attention_fwd_p2n_reference}):
            enc, hw = model.prepare_denoiser(pair_feat, mres, reps, **kw)
            outs.append(model.eps_net(v, p, rep(batch['aa']), rep(res_feat),
                                      pair_feat, beta, gen, mres, reps=reps,
                                      encoder_fn=enc, head_weights=hw))
    torch.cuda.synchronize()
    layers = model.cfg.num_layers
    assert ia.ipa_attention_fwd_p2n.launches == layers
    assert ia.ipa_attention_fwd_p2n_reference.calls == layers
    assert gb.gablock_layer.launches == gb.fused_encoder_chained.launches == 0
    got, want = outs
    for i in (1, 2, 3):   # R_next, eps_pos, c_denoised
        assert torch.isfinite(got[i]).all()
        assert float((got[i].float() - want[i].float()).abs().max()) < 0.01


@pytest.mark.cuda
def test_train_cli_on_card(tmp_path):
    """python -m ab_opt_tpu_torch.runners.train_cli on the card at full
    widths, two layers and four diffusion steps on a mini-SAbDab: 3 steps,
    one K2 and one K3 launch a layer a step, a sampling eval through K1, the
    checkpoints and the eval's files."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    import math
    import yaml
    from ab_opt_tpu_torch.ops import ipa_attention as ia
    from ab_opt_tpu_torch.runners import train_cli
    from ab_opt_tpu_torch.train import trainer as tr
    from ab_opt_tpu_torch.utils.bench_fixture import write_mini_sabdab
    paths = write_mini_sabdab(str(tmp_path / 'sabdab'), n=26)
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, 'configs', 'train',
                           'codesign_single.yml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['diffusion'].update(num_steps=4,
                                     eps_net_opt={'num_layers': 2})
    cfg['train'].update(max_iters=3, val_freq=3, sampling_eval={
        'enabled': True, 'num_items': 2, 'num_samples': 2})
    for split in ('train', 'val'):
        cfg['dataset'][split].update(paths)
    yml = tmp_path / 'cfg.yml'
    yml.write_text(yaml.safe_dump(cfg))
    seen, step = [], tr.Trainer.train_step

    def recording_step(self, *a, **k):
        before = (ia.ipa_attention_fwd.launches,
                  ia.ipa_attention_bwd.launches)
        losses = step(self, *a, **k)
        seen.append((ia.ipa_attention_fwd.launches - before[0],
                     ia.ipa_attention_bwd.launches - before[1],
                     [float(v) for v in losses.values()]))
        return losses

    gb.reset_counts()
    ia.reset_counts()
    tr.Trainer.train_step = recording_step
    try:
        trainer = train_cli.main(['--config', str(yml), '--logdir',
                                  str(tmp_path / 'logs')])
    finally:
        tr.Trainer.train_step = step
    assert trainer.device.type == 'cuda' and trainer.iteration == 3
    assert [(k2, k3) for k2, k3, _ in seen] == [(2, 2)] * 3
    assert all(math.isfinite(v) for *_, ls in seen for v in ls)
    assert gb.gablock_layer.launches == 2 * 4
    assert ia.ipa_attention_fwd_reference.calls == 0
    log_dir = tmp_path / 'logs' / next(p.name for p in
                                       (tmp_path / 'logs').iterdir())
    assert (log_dir / 'checkpoints' / '3.ckpt').exists()
    assert list((log_dir / 'checkpoints').glob('best_rmsd_*.ckpt'))
    assert (log_dir / 'sampling_eval' / 'it3' / 'results.csv').exists()


@pytest.mark.cuda
def test_gnn_loss_and_grads_on_card_match_cpu():
    """The graph model (PyTorch ops; JAX has no Pallas kernel there) at
    full width, two layers: one loss and its gradients on the card against
    the same model on the CPU (same weights, batch, t and draws; dropout 0,
    float32 with TF32 off): each loss within 1e-4 relative, each gradient
    within 1e-3 of its largest value."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    import copy

    import numpy as np
    from ab_opt_tpu_torch.models import DiffGNN, DiffGNNConfig
    from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = DiffGNN(DiffGNNConfig(n_layers=2, dropout=0.0))
    batch = synthetic_batch(np.random.default_rng(0), N=2, L=64, n_ab=40,
                            gen_lo=20, gen_hi=30)
    batch['hotspot_label'] = torch.ones_like(batch['aa'])
    N, L = batch['aa'].shape
    g = torch.Generator().manual_seed(1)
    draws = {'rot_axis': torch.randn(N, L, 3, generator=g),
             'rot_u': torch.rand(N, L, generator=g),
             'rot_frac': torch.rand(N, L, generator=g),
             'rot_gauss': torch.randn(N, L, generator=g),
             'pos': torch.randn(N, L, 3, generator=g)}
    terms = ('rot', 'pos', 'bb_pos', 'seq')
    out = []
    for dev in ('cpu', 'cuda'):
        m = copy.deepcopy(model).to(dev)
        to = lambda d: {k: v.to(dev) for k, v in d.items()}
        losses = m.loss(to(batch), t=torch.tensor([10, 300], device=dev),
                        draws=to(draws))
        sum(losses[k] for k in terms).backward()
        out.append(({k: float(losses[k].detach()) for k in terms},
                    {k: p.grad.cpu() for k, p in m.named_parameters()
                     if p.grad is not None}))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    for k in terms:
        assert abs(l_gpu[k] - l_cpu[k]) <= 1e-4 * abs(l_cpu[k]), k
    assert sorted(g_gpu) == sorted(g_cpu)
    for k, v in g_cpu.items():
        assert torch.isfinite(g_gpu[k]).all(), k
        assert float((g_gpu[k] - v).abs().max()) <= 1e-3 * float(
            v.abs().max()) + 1e-8, k
