"""The GABlock (IPA block) forward: one layer (K1) or the whole encoder in
one launch (K5), the Hopper kernels, their wrappers and their plain
PyTorch versions.

Counterpart of ``ab_opt_tpu/ops/gablock_pallas.py`` (``_gablock_kernel``,
``fused_gablock_layer``, ``build_gablock_weights``; ``_encoder_chain_kernel``,
``fused_encoder_chained``, ``stack_encoder_weights``). The kernel sources
are ``csrc/gablock.cu`` (whose launches also run the variant harness S4,
:mod:`.gablock_variants`) and ``csrc/gablock_chain.cu``; each is compiled
with ``nvcc`` for ``sm_90a`` into ``_build/`` at first use and loaded with
``ctypes``.

:func:`gablock_layer` and :func:`fused_encoder_chained` dispatch on the
device of their input: a CPU tensor takes the plain version
(:func:`gablock_layer_reference`, :func:`fused_encoder_chained_reference`),
a CUDA tensor launches the kernel or raises. There is no fallback.

Weight bundle (:func:`build_gablock_weights`), built once per sampling call
from a :class:`ab_opt_tpu_torch.nn.ipa.GABlock`:

* ``w_proj`` (F, PW): [Wq | Wk | Wv | Wqp | Wkp | Wvp] with every point
  block planar ([x | y | z], head-major inside), zero-padded to a multiple
  of 128 columns;
* ``coef`` (H,) f32: the spatial logit coefficient, 1/sqrt(3) included;
* ``w_out`` (KO, F), ``b_out``: out_transform with planar point rows;
* ``ln1``/``ln2`` (2, F) f32 (gamma, beta); ``w_m1..3`` (F, F), ``b_m``
  (3, F) f32: the transition MLP;
* ``w_proj_t``, ``w_out_t``, ``w_m1_t``..``w_m3_t``: the same five matrices
  transposed, (N, K) with K contiguous, as K1's and K5's GEMM tile reads
  them (S4 runs K1's launches and reads them too);
* ``dims``: (H, QK, V, P, PV).

Per-complex inputs under trajectory fan-out (row n belongs to complex
n // reps): ``z`` (Nc, L, L, Cz) and ``bias`` (Nc, H, L, L) from
:func:`ab_opt_tpu_torch.nn.ipa.precompute_pair_bias`. The chain takes the
bundles stacked along a leading layer axis (:func:`stack_encoder_weights`)
and the biases stacked as (Nc, NL, H, L, L).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

_SRC = build.CSRC_DIR / 'gablock.cu'
_CHAIN_SRC = build.CSRC_DIR / 'gablock_chain.cu'
_LN_EPS = 1e-10


# ------------------------------------------------------------ weight prep


def point_planar_perm(H: int, P: int) -> torch.Tensor:
    """Interleaved (h, p, xyz) point layout -> planar ([x | y | z] blocks,
    head-major inside): ``planar[i] = interleaved[perm[i]]``."""
    c = torch.arange(3).view(3, 1, 1)
    h = torch.arange(H).view(1, H, 1)
    p = torch.arange(P).view(1, 1, P)
    return ((h * P + p) * 3 + c).reshape(-1)


def build_gablock_weights(block, dtype=torch.bfloat16) -> dict:
    """Kernel weight bundle for one :class:`~ab_opt_tpu_torch.nn.ipa.GABlock`.

    The block keeps the reference's interleaved point layout; the planar
    permutation the kernel wants is applied here, once.
    """
    H, QK, V, P, PV = block.dims
    F = block.node_feat_dim
    f32 = torch.float32
    with torch.no_grad():
        wt = lambda lin: lin.weight.detach().to(f32).t()           # (in, out)
        w_pts = [wt(lin)[:, point_planar_perm(H, n)]
                 for lin, n in ((block.proj_query_point, P),
                                (block.proj_key_point, P),
                                (block.proj_value_point, PV))]
        w_proj = torch.cat([wt(block.proj_query), wt(block.proj_key),
                            wt(block.proj_value)] + w_pts, dim=1)
        pw = -(-w_proj.shape[1] // 128) * 128
        w_proj = torch.nn.functional.pad(w_proj, (0, pw - w_proj.shape[1]))

        w_out = wt(block.out_transform)                             # (KO, F)
        o0 = H * (block.pair_feat_dim + V)
        o1, o2 = o0 + 3 * H * PV, o0 + 4 * H * PV
        perm = point_planar_perm(H, PV)
        w_out = torch.cat([w_out[:o0], w_out[o0:o1][perm], w_out[o1:o2],
                           w_out[o2:][perm]], dim=0)

        ln = lambda m: torch.stack([m.gamma, m.beta]).detach().to(f32)
        mlp = [block.mlp_transition[i] for i in (0, 2, 4)]
        wb = {
            'w_proj': w_proj.to(dtype).contiguous(),
            'coef': block.spatial_coefficient().detach().to(f32)
                    * math.sqrt(1.0 / 3.0),
            'w_out': w_out.to(dtype).contiguous(),
            'b_out': block.out_transform.bias.detach().to(f32),
            'ln1': ln(block.layer_norm_1),
            'w_m1': wt(mlp[0]).to(dtype).contiguous(),
            'w_m2': wt(mlp[1]).to(dtype).contiguous(),
            'w_m3': wt(mlp[2]).to(dtype).contiguous(),
            'b_m': torch.stack([m.bias.detach().to(f32) for m in mlp]),
            'ln2': ln(block.layer_norm_2),
            'dims': (H, QK, V, P, PV),
        }
        for name in TRANSPOSED:
            wb[name + '_t'] = wb[name].t().contiguous()
        return wb


# The weight matrices K1's GEMM reads transposed (bundle key + '_t').
TRANSPOSED = ('w_proj', 'w_out', 'w_m1', 'w_m2', 'w_m3')


def build_encoder_weights(encoder, dtype=torch.bfloat16) -> list:
    """Bundles for every block of a GAEncoder: constant across diffusion
    steps, so samplers build them once per sampling call."""
    return [build_gablock_weights(b, dtype) for b in encoder.blocks]


def stack_encoder_weights(bundles) -> dict:
    """Stack per-layer bundles along a leading layer axis for the chained
    whole-encoder kernel (:func:`fused_encoder_chained`); ``dims`` is kept."""
    stacked = {k: torch.stack([wb[k] for wb in bundles]).contiguous()
               for k in bundles[0] if k != 'dims'}
    stacked['dims'] = bundles[0]['dims']
    return stacked


def _layer_bundle(stacked, i: int) -> dict:
    return {k: v if k == 'dims' else v[i] for k, v in stacked.items()}


# ------------------------------------------------------------ plain version


def _layernorm(x, ln):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * ln[0] + ln[1]


def attention_replicas(reps: int) -> int:
    """Replicas one block of K1's attention serves (its rt): the largest of
    4, 2 and 1 that divides ``reps``; they share the block's bias rows."""
    return next(rt for rt in (4, 2, 1) if reps % rt == 0)


def gablock_attention_reference(qa, ka, vv, bias, reps: int = 1):
    """K1's attention in plain PyTorch: qa, ka, vv (N, L, H*64) and bias
    (Nc, H, L, L) -> o (N, L, H*64) and alpha (Nc, L, reps*H, L), both in
    the inputs' dtype. The logits, softmax and products run in f32 on the
    inputs as given; alpha is rounded to the dtype before alpha . vv."""
    gablock_attention_reference.calls += 1
    f32, dt = torch.float32, qa.dtype
    N, L, HD = qa.shape
    H, Nc = HD // 64, N // reps
    per_head = lambda a: a.to(f32).reshape(N, L, H, 64)
    logits = torch.einsum('nihd,njhd->nhij', per_head(qa), per_head(ka))
    logits = (logits.reshape(Nc, reps, H, L, L)
              + bias.to(f32)[:, None]).reshape(N, H, L, L)
    alpha = torch.softmax(logits, dim=-1).to(dt)
    o = torch.einsum('nhij,njhd->nihd', alpha.to(f32), per_head(vv))
    alpha = alpha.reshape(Nc, reps * H, L, L).transpose(1, 2).contiguous()
    return o.reshape(N, L, HD).to(dt), alpha


gablock_attention_reference.calls = 0


def gablock_p2n_reference(alpha, z, reps: int = 1):
    """K1's p2n in plain PyTorch: alpha (Nc, L, reps*H, L) and z (Nc, L, L,
    Cz) -> p2n (N, L, H, Cz), p2n[c reps + r, i, h] = sum_j alpha[c, i,
    r H + h, j] z[c, i, j], in f32, rounded to alpha's dtype."""
    gablock_p2n_reference.calls += 1
    Nc, L, RH, _ = alpha.shape
    H, Cz = RH // reps, z.shape[-1]
    p2n = torch.einsum('cimj,cijd->cimd', alpha.to(torch.float32),
                       z.to(torch.float32))
    return (p2n.reshape(Nc, L, reps, H, Cz).transpose(1, 2)
            .reshape(Nc * reps, L, H, Cz).to(alpha.dtype))


gablock_p2n_reference.calls = 0


def gablock_gemm_reference(a, w_t, bias=None, relu=False, resid=None,
                           rowmask=None, ln=None):
    """K1's GEMM in plain PyTorch: bf16(a) (M, K) times bf16(w_t) (N, K)
    transposed, in f32. Without ``ln``: bf16(y + bias, ReLU if ``relu``);
    with ``ln`` (gamma, beta): f32 LayerNorm(resid + (y + bias) * rowmask)
    over the row."""
    gablock_gemm_reference.calls += 1
    f32, bf16 = torch.float32, torch.bfloat16
    y = a.to(bf16).to(f32) @ w_t.to(bf16).to(f32).t()
    if ln is None:
        y = y if bias is None else y + bias
        return (torch.relu(y) if relu else y).to(bf16)
    y = y + bias
    if rowmask is not None:
        y = y * rowmask[:, None]
    return _layernorm(resid + y, ln)


gablock_gemm_reference.calls = 0


def gablock_layer_reference(x, R9, t, z, bias, mask, wb, reps: int = 1,
                            dtype=None):
    """The kernel's function in plain PyTorch: x (N, L, F) -> (N, L, F) f32.

    ``dtype`` (default: the bundle's weight dtype) is the compute type. In
    bf16 it rounds where the kernel stores bf16 (x, the projections,
    qa/ka/vvp, alpha, the attention values, p2n, the feature matrix and the
    MLP inputs) and keeps R, t, softmax and LayerNorm in f32; in f32 it is
    the module math of :class:`~ab_opt_tpu_torch.nn.ipa.GABlock`.
    """
    gablock_layer_reference.calls += 1
    return _layer_math(x, R9, t, z, bias, mask, wb, reps, dtype)


gablock_layer_reference.calls = 0


def _layer_math(x, R9, t, z, bias, mask, wb, reps, dtype, abl=frozenset()):
    """The layer; ``abl``, a set of the phase-ablation flags of
    :mod:`.gablock_variants`, skips or fakes the phases it names (one line
    each, marked ``abl``). The empty set is the layer itself."""
    dt = dtype or wb['w_proj'].dtype
    f32 = torch.float32
    rnd = lambda a: a.to(dt).to(f32)
    mm = lambda a, w: rnd(a) @ rnd(w)
    H, QK, V, P, PV = wb['dims']
    HP, HPV = H * P, H * PV
    N, L, F = x.shape
    Nc = N // reps
    x = x.to(f32)
    Rm = R9.to(f32).reshape(N, L, 3, 3)
    tt = t.to(f32)[..., None]                                  # (N, L, 3, 1)

    proj = rnd(mm(x, wb['w_proj']))
    sizes = (H * QK, H * QK, H * V, 3 * HP, 3 * HP, 3 * HPV)
    q, k, v, qp, kp, vp = torch.split(proj[..., :sum(sizes)], sizes, -1)
    to_global = lambda p, n: (
        torch.einsum('nlcd,nldk->nlck', Rm, p.reshape(N, L, 3, n)) + tt)
    if 'skip_rot' in abl:                                      # abl
        to_global = lambda p, n: p.reshape(N, L, 3, n)
    per_head = lambda g, n: g.reshape(N, L, 3, H, n).permute(0, 1, 3, 2, 4)
    qgp, kgp = to_global(qp, HP), to_global(kp, HP)            # (N, L, 3, HP)
    qg, kg = per_head(qgp, P), per_head(kgp, P)              # (N, L, H, 3, P)
    vg = per_head(to_global(vp, HPV), PV)

    coef = wb['coef'].to(f32)                                  # (H,)
    sq_q = qg.square().sum((3, 4))                             # (N, L, H)
    sq_k = kg.square().sum((3, 4))
    if 'skip_sq' in abl:                                       # abl
        sq_q, sq_k = qgp[:, :, 0, :H], kgp[:, :, 0, :H]
    if 'thin_ops' in abl:                                      # abl
        qg, kg, vg, sq_q, sq_k = map(torch.zeros_like,
                                     (qg, kg, vg, sq_q, sq_k))
    ones = torch.ones_like(sq_q)
    qa = rnd(torch.cat([
        q.reshape(N, L, H, QK) / math.sqrt(3.0 * QK),
        (-2.0 * coef[:, None]) * qg.reshape(N, L, H, 3 * P),
        (coef * sq_q)[..., None], (coef * ones)[..., None]], -1))
    ka = rnd(torch.cat([k.reshape(N, L, H, QK), kg.reshape(N, L, H, 3 * P),
                        ones[..., None], sq_k[..., None]], -1))
    vv = rnd(torch.cat([v.reshape(N, L, H, V), vg.reshape(N, L, H, 3 * PV)],
                       -1))

    bias_n = bias.to(f32)[:, None].expand(Nc, reps, H, L, L)
    logits = torch.einsum('nihd,njhd->nhij', qa, ka)
    logits = (logits.reshape(Nc, reps, H, L, L) + bias_n).reshape(N, H, L, L)
    alpha = rnd(torch.softmax(logits, dim=-1))
    if 'fake_softmax' in abl:                                  # abl
        alpha = rnd(0.01 * logits)
    if 'fake_alpha' in abl:                                    # abl
        alpha = rnd(0.01 * bias_n.reshape(N, H, L, L))
    out = rnd(torch.einsum('nhij,njhd->nihd', alpha, vv))      # (N, L, H, .)
    if 'skip_values' in abl:                                   # abl
        out = vv
    p2n = rnd(torch.einsum('crhij,cijd->crihd',
                           alpha.reshape(Nc, reps, H, L, L), z.to(f32)))
    p2n = p2n.reshape(N, L, -1)
    if 'skip_p2n' in abl:                                      # abl
        p2n = torch.zeros_like(p2n)

    node = out[..., :V].reshape(N, L, H * V)
    og = out[..., V:].reshape(N, L, H, 3, PV).permute(0, 1, 3, 2, 4)
    loc = torch.einsum('nldc,nldk->nlck', Rm,
                       og.reshape(N, L, 3, HPV) - tt)          # R^T (g - t)
    if 'skip_rot' in abl:                                      # abl
        loc = og.reshape(N, L, 3, HPV)
    ss = loc.square().sum(2)
    dist = torch.sqrt(ss + 1e-12)
    dirn = loc / (torch.sqrt(ss + 1e-8) + 1e-4)[:, :, None]
    feat = torch.cat([p2n, node, loc.reshape(N, L, -1), dist,
                      dirn.reshape(N, L, -1)], -1)
    if 'fake_feat' in abl:                                     # abl
        # o in its 64-wide slots [V | x | y | z points | zero pad], then
        # its first columns again, up to the H (V + 7 PV) feature columns.
        o64 = torch.nn.functional.pad(out, (0, 64 - out.shape[-1]))
        o64 = o64.reshape(N, L, H * 64)
        feat = torch.cat([p2n, o64, o64[..., :H * (V + 7 * PV - 64)]], -1)

    y = (mm(feat, wb['w_out']) + wb['b_out']) * mask.to(f32)[..., None]
    x1 = _layernorm(x + y, wb['ln1'])
    if 'skip_mlp' in abl:                                      # abl
        return x1
    h1 = torch.relu(mm(x1, wb['w_m1']) + wb['b_m'][0])
    h2 = torch.relu(mm(h1, wb['w_m2']) + wb['b_m'][1])
    h3 = mm(h2, wb['w_m3']) + wb['b_m'][2]
    return _layernorm(x1 + h3, wb['ln2'])


def fused_encoder_chained_reference(stacked, num_layers: int, R9, t, x, z,
                                    biases, mask, reps: int = 1):
    """The chained kernel's function in plain PyTorch: ``num_layers``
    GABlock layers in sequence, each with the rounding points of
    :func:`gablock_layer_reference`, layer i on ``stacked``'s slice i and
    ``biases[:, i]``. ``biases`` (Nc, NL, H, L, L); the rest as
    :func:`gablock_layer`. Counts its calls, not the per-layer version's."""
    fused_encoder_chained_reference.calls += 1
    for i in range(num_layers):
        x = _layer_math(x, R9, t, z, biases[:, i], mask,
                        _layer_bundle(stacked, i), reps, None)
    return x


fused_encoder_chained_reference.calls = 0


# ------------------------------------------------------------ the kernel


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(
        build.build_sources([_SRC], build.BUILD_DIR)[str(_SRC)]['path'])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gablock_workspace_bytes.argtypes = [I, I, I, I, I]
    lib.gablock_workspace_bytes.restype = ctypes.c_size_t
    layer = [P] * 7 + [I] + [P] * 2 + [I] + [P] * 9 + [I] * 4 + [P]
    lib.gablock_forward.argtypes = layer + [I]
    lib.gablock_forward.restype = I
    lib.gablock_forward_variant.argtypes = layer + [I] * 2
    lib.gablock_forward_variant.restype = I
    lib.gablock_attention.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.gablock_attention.restype = I
    lib.gablock_p2n.argtypes = [P] * 3 + [I] * 4 + [P]
    lib.gablock_p2n.restype = I
    lib.gablock_gemm.argtypes = ([P, I, P] + [I] * 3 + [P, I]
                                 + [P] * 5 + [P])
    lib.gablock_gemm.restype = I
    lib.gablock_error_string.argtypes = [I]
    lib.gablock_error_string.restype = ctypes.c_char_p
    return lib


def _require(cond: bool, msg, who: str = 'gablock_layer'):
    """Raise ValueError(who: msg) unless ``cond``; ``msg`` may be a callable,
    formatted only on failure (the checks run on every launch)."""
    if not cond:
        raise ValueError(f'{who}: {msg() if callable(msg) else msg}')


def _expected(x, R9, t, z, mask, wb, reps: int, lead=(),
              who: str = 'gablock_layer') -> dict:
    """{name: (tensor, shape, dtype)} of every operand K1 and K5 share, the
    weights with the leading dims ``lead`` (K5's layer axis); raises on a
    geometry the kernels do not take."""
    req = lambda cond, msg: _require(cond, msg, who)
    H, QK, V, P, PV = wb['dims']
    req((QK, V, P, PV) == (32, 32, 8, 8),
        lambda: f'head geometry {wb["dims"]} (kernel takes QK=V=32, P=PV=8)')
    req(H % 4 == 0, lambda: f'H={H} must be a multiple of 4')
    req(x.dim() == 3, 'x must be (N, L, F)')
    N, L, F = x.shape
    req(F == 128, lambda: f'node width {F} (kernel takes 128)')
    req(L % 16 == 0 and 16 <= L <= 256,
        lambda: f'L={L} (multiple of 16, <=256)')
    req(reps >= 1 and N % reps == 0,
        lambda: f'reps={reps} must divide N={N}')
    Nc = N // reps
    f32, bf16 = torch.float32, torch.bfloat16
    ko = H * (64 + V + 7 * PV)
    pw = wb['w_proj'].shape[-1]
    req(pw % 128 == 0 and pw >= H * 168, lambda: f'w_proj width {pw}')
    expect = {
        'x': (x, (N, L, F), f32), 'R9': (R9, (N, L, 9), f32),
        't': (t, (N, L, 3), f32), 'mask': (mask, (N, L), f32),
        'z': (z, (Nc, L, L, 64), bf16)}
    weights = {
        'w_proj': ((F, pw), bf16), 'w_out': ((ko, F), bf16),
        'b_out': ((F,), f32), 'coef': ((H,), f32), 'ln1': ((2, F), f32),
        'ln2': ((2, F), f32), 'w_m1': ((F, F), bf16),
        'w_m2': ((F, F), bf16), 'w_m3': ((F, F), bf16),
        'b_m': ((3, F), f32)}
    for name, (shape, dtype) in weights.items():
        expect[name] = (wb[name], tuple(lead) + shape, dtype)
    return expect


def _check_tensors(expect: dict, x, who: str = 'gablock_layer'):
    """Dtype, shape and contiguity of every operand, then its device."""
    for name, (a, shape, dtype) in expect.items():
        if a.dtype != dtype or a.shape != shape or not a.is_contiguous():
            _require(a.dtype == dtype,
                     lambda: f'{name} dtype {a.dtype}, expected {dtype}', who)
            _require(a.shape == shape, lambda: f'{name} shape '
                     f'{tuple(a.shape)}, expected {shape}', who)
            _require(False, f'{name} must be contiguous', who)
    device = x.device
    for name, (a, _, _) in expect.items():
        if not (a.is_cuda and a.device == device):
            _require(False, f'{name} must lie on the CUDA device of x, not '
                     f'{a.device}', who)


def _check_inputs(x, R9, t, z, bias, mask, wb, reps: int,
                  who: str = 'gablock_layer'):
    """Raise on anything the kernel does not take (shapes, dtypes,
    contiguity, then device, then the transposed weights K1 reads)."""
    expect = _expected(x, R9, t, z, mask, wb, reps, who=who)
    N, L, _ = x.shape
    H = wb['dims'][0]
    expect['bias'] = (bias, (N // reps, H, L, L), torch.bfloat16)
    _check_tensors(expect, x, who)
    missing = [n + '_t' for n in TRANSPOSED if n + '_t' not in wb]
    _require(not missing, f'the bundle lacks {missing} (build it with '
             'build_gablock_weights)', who)
    _check_tensors({n + '_t': (wb[n + '_t'], tuple(wb[n].shape[::-1]),
                               torch.bfloat16) for n in TRANSPOSED}, x, who)


def gablock_layer(x, R9, t, z, bias, mask, wb, reps: int = 1):
    """One GABlock layer: x (N, L, F) f32 -> updated x (N, L, F) f32.

    R9 (N, L, 9) row-major rotations, t (N, L, 3) frame origins, mask (N, L)
    f32, z (Nc, L, L, Cz) and bias (Nc, H, L, L) per complex. A CPU ``x``
    takes the plain version; any other device launches the kernel (one
    count on ``gablock_layer.launches`` per call) or raises.
    """
    if x.device.type == 'cpu':
        return gablock_layer_reference(x, R9, t, z, bias, mask, wb, reps)
    _check_inputs(x, R9, t, z, bias, mask, wb, reps)
    out = _launch_layer('gablock_forward', x, R9, t, z, bias, mask, wb, reps,
                        attention_replicas(reps))
    gablock_layer.launches += 1
    return out


def _launch_error(lib, err: int, what: str = 'gablock kernel'):
    if err != 0:
        msg = lib.gablock_error_string(err).decode()
        raise RuntimeError(f'{what} launch failed: CUDA error {err} ({msg})')


def _launch_layer(entry: str, x, R9, t, z, bias, mask, wb, reps, *extra):
    """One launch of the layer entry ``entry`` of ``csrc/gablock.cu``
    (``gablock_forward``, K1, with ``extra`` (rt,), or
    ``gablock_forward_variant``, S4, with ``extra`` (abl, rt); both read
    the transposed weights) on checked CUDA inputs; raises if a launch was
    refused."""
    lib = _library()
    N, L, F = x.shape
    H = wb['dims'][0]
    pw, ko = wb['w_proj'].shape[1], wb['w_out'].shape[0]
    with torch.cuda.device(x.device):
        ws = torch.empty(lib.gablock_workspace_bytes(N, L, H, pw, ko),
                         dtype=torch.uint8, device=x.device)
        out = torch.empty_like(x)
        ptr = lambda a: a.data_ptr()
        err = getattr(lib, entry)(
            ptr(x), ptr(R9), ptr(t), ptr(z), ptr(bias), ptr(mask),
            ptr(wb['w_proj_t']), pw, ptr(wb['coef']), ptr(wb['w_out_t']), ko,
            ptr(wb['b_out']), ptr(wb['ln1']), ptr(wb['w_m1_t']),
            ptr(wb['w_m2_t']), ptr(wb['w_m3_t']), ptr(wb['b_m']),
            ptr(wb['ln2']), ptr(out), ptr(ws), N, L, H, reps,
            torch.cuda.current_stream(x.device).cuda_stream, *extra)
    _launch_error(lib, err)
    return out


gablock_layer.launches = 0


def gablock_attention(qa, ka, vv, bias, reps: int = 1):
    """K1's attention launch alone (the layer runs it inside
    :func:`gablock_layer`): bf16 qa, ka, vv (N, L, H*64) and bias (Nc, H,
    L, L) -> o (N, L, H*64) and alpha (Nc, L, reps*H, L). A CPU ``qa``
    takes the plain version; any other device launches the kernel (one
    count on ``gablock_attention.launches``) or raises."""
    who = 'gablock_attention'
    if qa.device.type == 'cpu':
        return gablock_attention_reference(qa, ka, vv, bias, reps)
    _require(qa.dim() == 3 and qa.shape[-1] % 64 == 0,
             'qa must be (N, L, H*64)', who)
    N, L, HD = qa.shape
    H = HD // 64
    _require(L % 16 == 0 and 16 <= L <= 256, f'L={L} (multiple of 16, <=256)',
             who)
    _require(reps >= 1 and N % reps == 0, f'reps={reps} must divide N={N}',
             who)
    bf16 = torch.bfloat16
    _check_tensors({'qa': (qa, (N, L, HD), bf16), 'ka': (ka, (N, L, HD), bf16),
                    'vv': (vv, (N, L, HD), bf16),
                    'bias': (bias, (N // reps, H, L, L), bf16)}, qa, who)
    lib = _library()
    with torch.cuda.device(qa.device):
        o = torch.empty_like(qa)
        alpha = torch.empty(N // reps, L, reps * H, L, dtype=bf16,
                            device=qa.device)
        err = lib.gablock_attention(
            qa.data_ptr(), ka.data_ptr(), vv.data_ptr(), bias.data_ptr(),
            o.data_ptr(), alpha.data_ptr(), N, L, H, reps,
            attention_replicas(reps),
            torch.cuda.current_stream(qa.device).cuda_stream)
    _launch_error(lib, err, who)
    gablock_attention.launches += 1
    return o, alpha


gablock_attention.launches = 0


def gablock_p2n(alpha, z, reps: int = 1):
    """K1's p2n launch alone (the layer runs it inside
    :func:`gablock_layer`, into the feature rows): bf16 alpha (Nc, L,
    reps*H, L), as :func:`gablock_attention` returns it, and z (Nc, L, L,
    64) -> p2n (N, L, H, 64). A CPU ``alpha`` takes the plain version; any
    other device launches the kernel (one count on ``gablock_p2n.launches``)
    or raises."""
    who = 'gablock_p2n'
    if alpha.device.type == 'cpu':
        return gablock_p2n_reference(alpha, z, reps)
    _require(alpha.dim() == 4 and z.dim() == 4,
             'alpha must be (Nc, L, reps*H, L) and z (Nc, L, L, 64)', who)
    Nc, L, RH, _ = alpha.shape
    _require(L % 16 == 0 and 16 <= L <= 256, f'L={L} (multiple of 16, <=256)',
             who)
    _require(reps >= 1 and RH % reps == 0, f'reps={reps} must divide {RH}',
             who)
    bf16 = torch.bfloat16
    _check_tensors({'alpha': (alpha, (Nc, L, RH, L), bf16),
                    'z': (z, (Nc, L, L, 64), bf16)}, alpha, who)
    N, H = Nc * reps, RH // reps
    lib = _library()
    with torch.cuda.device(alpha.device):
        p2n = torch.empty(N, L, H, 64, dtype=bf16, device=alpha.device)
        err = lib.gablock_p2n(alpha.data_ptr(), z.data_ptr(), p2n.data_ptr(),
                              N, L, H, reps,
                              torch.cuda.current_stream(alpha.device)
                              .cuda_stream)
    _launch_error(lib, err, who)
    gablock_p2n.launches += 1
    return p2n


gablock_p2n.launches = 0


def gablock_gemm(a, w_t, bias=None, relu=False, resid=None, rowmask=None,
                 ln=None):
    """K1's GEMM alone (the layer runs it five times inside
    :func:`gablock_layer`), :func:`gablock_gemm_reference`'s function: an
    f32 ``a`` (M, 128) is the projection (N a multiple of 128, bf16 out);
    a bf16 ``a`` (M, K) takes N = 128 and the bf16 or, with ``ln``, the
    LayerNorm epilogue (f32 out). A CPU ``a`` takes the plain version; any
    other device launches the kernel (one count on
    ``gablock_gemm.launches``) or raises."""
    who = 'gablock_gemm'
    if a.device.type == 'cpu':
        return gablock_gemm_reference(a, w_t, bias, relu, resid, rowmask, ln)
    f32, bf16 = torch.float32, torch.bfloat16
    _require(a.dim() == 2 and w_t.dim() == 2, 'a and w_t must be 2-d', who)
    M, K = a.shape
    N = w_t.shape[0]
    proj = a.dtype == f32
    _require(K % 8 == 0 and (K == 128 if proj else N == 128),
             f'a {tuple(a.shape)}, w_t {tuple(w_t.shape)}: the projection '
             'takes f32 (M, 128), the others bf16 (M, K) with N = 128', who)
    _require(not (proj and ln is not None), 'the projection has no LN', who)
    expect = {'a': (a, (M, K), a.dtype), 'w_t': (w_t, (N, K), bf16)}
    if bias is not None:
        expect['bias'] = (bias, (N,), f32)
    if ln is not None:
        _require(bias is not None and resid is not None,
                 'the LN epilogue takes bias and resid', who)
        expect.update(resid=(resid, (M, N), f32), ln=(ln, (2, N), f32))
        if rowmask is not None:
            expect['rowmask'] = (rowmask, (M,), f32)
    _check_tensors(expect, a, who)
    lib = _library()
    ptr = lambda t_: 0 if t_ is None else t_.data_ptr()
    with torch.cuda.device(a.device):
        out = torch.empty(M, N, dtype=f32 if ln is not None else bf16,
                          device=a.device)
        out_f32, out_bf16 = (out, None) if ln is not None else (None, out)
        err = lib.gablock_gemm(
            ptr(a), int(proj), ptr(w_t), M, K, N, ptr(bias), int(relu),
            ptr(resid), ptr(rowmask), ptr(ln), ptr(out_f32), ptr(out_bf16),
            torch.cuda.current_stream(a.device).cuda_stream)
    _launch_error(lib, err, who)
    gablock_gemm.launches += 1
    return out


gablock_gemm.launches = 0


# ------------------------------------------------------------ K5, the chain


CHAIN_PROFILE_FLAGS = ('-DGABLOCK_CHAIN_PROFILE',)
# K5's work items (csrc/gablock_chain.cu): their kinds in phase order, the
# rows of a row block (a proj or tail item's, and the most an assemble or
# feat item takes), the query rows of an attention item (K5's blocks have 8
# warps) and the alpha rows of a p2n item.
CHAIN_KINDS = ('proj', 'assemble', 'attention', 'feat', 'p2n', 'tail')
CHAIN_ROWS = 128
CHAIN_QT = 128
CHAIN_P2N_M = 128


@functools.lru_cache(maxsize=None)
def _chain_library(flags=()):
    """K5's library; ``CHAIN_PROFILE_FLAGS`` gives the profiling build
    (:mod:`ab_opt_tpu_torch.utils.profile_chain`), which also exports
    ``gablock_chain_profile_ns``."""
    lib = ctypes.CDLL(build.build_sources(
        [_CHAIN_SRC], build.BUILD_DIR, flags)[str(_CHAIN_SRC)]['path'])
    P, I, S, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_uint
    lib.gablock_chain_workspace_bytes.argtypes = [I] * 5
    lib.gablock_chain_workspace_bytes.restype = S
    lib.gablock_chain_launch_shape.argtypes = [I, I, ctypes.POINTER(I),
                                               ctypes.POINTER(I),
                                               ctypes.POINTER(S)]
    lib.gablock_chain_launch_shape.restype = I
    lib.gablock_chain_forward.argtypes = (
        [P] * 7 + [I] + [P] * 2 + [I] + [P] * 9 + [P, P, I, P, P, U]
        + [I] * 7 + [P])
    lib.gablock_chain_forward.restype = I
    lib.gablock_chain_error_string.argtypes = [I]
    lib.gablock_chain_error_string.restype = ctypes.c_char_p
    if flags == CHAIN_PROFILE_FLAGS:
        lib.gablock_chain_profile_ns.argtypes = [P, I]
        lib.gablock_chain_profile_ns.restype = I
    return lib


def _chain_error(lib, err: int, what: str):
    msg = lib.gablock_chain_error_string(err).decode()
    raise RuntimeError(f'fused_encoder_chained: {what} failed: error {err} '
                       f'({msg})')


def chain_launch_shape(L: int, H: int, lib=None) -> dict:
    """K5's persistent grid (blocks an SM x SMs), threads and shared memory
    a block at this L and H on the current card."""
    lib = lib or _chain_library()
    grid, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t()
    err = lib.gablock_chain_launch_shape(L, H, ctypes.byref(grid),
                                         ctypes.byref(threads),
                                         ctypes.byref(smem))
    if err != 0:
        _chain_error(lib, err, 'planning the launch')
    return {'grid': grid.value, 'threads': threads.value,
            'smem_bytes': smem.value}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chain_plan(N: int, L: int, H: int, reps: int, num_layers: int,
               sms: int, pw: int | None = None) -> dict:
    """K5's work list for one pass: every layer's items in ticket order,
    (layer, phase, replica group, tile), with the counters each waits on.

    Returns a dict of
    * ``items``: int32 (n, 8) rows (kind, layer, p0, p1, p2, signal counter,
      waits lo, hi), kinds indexing :data:`CHAIN_KINDS`: proj (row block,
      first column tile, end), assemble (first row, end row, 0), attention
      (query tile, head, replica group), feat (first row, end row, 0),
      p2n (first query row, alpha-row block, complex), tail (row block,
      0, 0);
    * ``waits``: int32 counter ids, item ``k``'s are ``waits[lo:hi]``;
    * ``totals``: int32, per counter the items that signal it: a wait is
      met once all of them have run;
    * ``keys``: each counter's (name, layer, ...) key; ``rt`` (replicas an
      attention item serves), ``p2n_rows`` (query rows a p2n item),
      ``asm_rows`` and ``feat_rows`` (rows an assemble or feat item) and
      ``splits`` (column splits of the projection).

    Row blocks are :data:`CHAIN_ROWS` rows of the (N L) rows; an assemble
    or feat item takes 16 to 128 rows of one, fewer where the rows are few,
    so that the items cover the SMs.

    ``sms`` sets the projection's column split as K1 sets it; ``pw`` (the
    projection width, default ``H * 168`` rounded up to 128) its tiles.
    """
    pw = pw or _cdiv(H * 168, 128) * 128
    M, Nc, rt = N * L, N // reps, attention_replicas(reps)
    MB, Q, RH = _cdiv(M, CHAIN_ROWS), _cdiv(L, CHAIN_QT), reps * H
    PMB, tiles = _cdiv(RH, CHAIN_P2N_M), pw // 128
    splits = max(1, min(tiles, _cdiv(sms, MB)))
    per = _cdiv(tiles, splits)
    # Fewer, larger items where the grid stays covered: each item costs a
    # claim, its waits and a release besides its work.
    p2n_rows = max(1, min(8, Nc * PMB * L // sms))
    asm_rows = next((r for r in (128, 64, 32) if M // r >= sms), 16)
    feat_rows = asm_rows
    keys, index = [], {}

    def counter(*key):
        if key not in index:
            index[key] = len(keys)
            keys.append(key)
        return index[key]

    def block_rows(mb):
        return mb * CHAIN_ROWS, min(M, (mb + 1) * CHAIN_ROWS)

    def segments(r0, r1):
        """(trajectory, first row, end row) of each trajectory in the rows
        [r0, r1)."""
        return [(n, max(r0, n * L) - n * L, min(r1, (n + 1) * L) - n * L)
                for n in range(r0 // L, (r1 - 1) // L + 1)]

    def group_blocks(g):
        return range(g * rt * L // CHAIN_ROWS,
                     ((g + 1) * rt * L - 1) // CHAIN_ROWS + 1)

    def query_tiles(i0, i1):
        return range(i0 // CHAIN_QT, (i1 - 1) // CHAIN_QT + 1)

    def alpha_blocks(rp):
        """The p2n items' alpha-row blocks that hold replica rp's heads."""
        return range(rp * H // CHAIN_P2N_M,
                     ((rp + 1) * H - 1) // CHAIN_P2N_M + 1)

    items, waits = [], []

    def add(kind, layer, p, signal, deps):
        deps = list(dict.fromkeys(deps))
        items.append((CHAIN_KINDS.index(kind), layer, *p, signal, len(waits),
                      len(waits) + len(deps)))
        waits.extend(deps)

    for l in range(num_layers):
        for mb in range(MB):
            for t0 in range(0, tiles, per):
                add('proj', l, (mb, t0, min(t0 + per, tiles)),
                    counter('proj', l, mb),
                    [counter('tail', l - 1, mb)] if l else [])
        for mb in range(MB):
            b0, b1 = block_rows(mb)
            for r0 in range(b0, b1, asm_rows):
                r1 = min(b1, r0 + asm_rows)
                # The K, V rows it overwrites were read by the last layer's
                # attention, which the last tail of these rows followed
                # (through p2n of every query row).
                add('assemble', l, (r0, r1, 0), counter('assemble', l, mb),
                    [counter('proj', l, mb)])
        for g in range(N // rt):
            for q in range(Q):
                for h in range(H):
                    add('attention', l, (q, h, g),
                        counter('attention', l, g, q),
                        [counter('assemble', l, mb) for mb in group_blocks(g)])
        for mb in range(MB):
            b0, b1 = block_rows(mb)
            for r0 in range(b0, b1, feat_rows):
                r1 = min(b1, r0 + feat_rows)
                deps = [counter('attention', l, n // rt, q)
                        for n, i0, i1 in segments(r0, r1)
                        for q in query_tiles(i0, i1)]
                add('feat', l, (r0, r1, 0), counter('feat', l, mb), deps)
        for c in range(Nc):
            for pm in range(PMB):
                m0, m1 = pm * CHAIN_P2N_M, min(RH, (pm + 1) * CHAIN_P2N_M)
                groups = sorted({(c * reps + rp) // rt
                                 for rp in range(m0 // H, (m1 - 1) // H + 1)})
                for i0 in range(0, L, p2n_rows):
                    qs = query_tiles(i0, min(L, i0 + p2n_rows))
                    add('p2n', l, (i0, pm, c), counter('p2n', l, c, pm),
                        [counter('attention', l, g, q)
                         for g in groups for q in qs])
        for mb in range(MB):
            deps = [counter('feat', l, mb)]
            for n, _, _ in segments(*block_rows(mb)):
                c, rp = divmod(n, reps)
                deps += [counter('p2n', l, c, pm) for pm in alpha_blocks(rp)]
            add('tail', l, (mb, 0, 0), counter('tail', l, mb), deps)

    items = torch.tensor(items, dtype=torch.int32).reshape(-1, 8)
    totals = torch.bincount(items[:, 5].long(), minlength=len(keys))
    return {'items': items, 'waits': torch.tensor(waits, dtype=torch.int32),
            'totals': totals.to(torch.int32), 'keys': keys, 'rt': rt,
            'p2n_rows': p2n_rows, 'asm_rows': asm_rows, 'feat_rows': feat_rows,
            'splits': _cdiv(tiles, per)}


# K5's state per (library, device, shape): the plan's tables on the card,
# the workspace, the counters and the launch epoch. Built at the first pass
# of a shape, kept for every later one; the passes of one shape share them,
# so they run one after another (one stream), as a sampler's steps do.
_CHAIN_STATE: dict = {}


def _chain_state(lib, device, N, L, H, reps, num_layers, pw, ko) -> dict:
    key = (id(lib), str(device), N, L, H, reps, num_layers, pw, ko)
    state = _CHAIN_STATE.get(key)
    if state is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = chain_plan(N, L, H, reps, num_layers, sms, pw)
        state = {k: plan[k].to(device) for k in ('items', 'waits', 'totals')}
        state.update(
            rt=plan['rt'], p2n_rows=plan['p2n_rows'], epoch=0,
            counters=torch.zeros(1 + len(plan['keys']), dtype=torch.int32,
                                 device=device),
            ws=torch.empty(lib.gablock_chain_workspace_bytes(N, L, H, pw, ko),
                           dtype=torch.uint8, device=device))
        _CHAIN_STATE[key] = state
    return state


def fused_encoder_chained(stacked, num_layers: int, R9, t, x, z, biases,
                          mask, reps: int = 1):
    """All ``num_layers`` GABlock layers in one launch: x (N, L, F) f32 ->
    encoded x (N, L, F) f32.

    ``stacked`` from :func:`stack_encoder_weights` (a leading layer axis of
    ``num_layers``), ``biases`` (Nc, NL, H, L, L) bf16; the rest as
    :func:`gablock_layer`. A CPU ``x`` takes the plain version; any other
    device launches the kernel (one count on
    ``fused_encoder_chained.launches`` per call) or raises.
    """
    if x.device.type == 'cpu':
        return fused_encoder_chained_reference(stacked, num_layers, R9, t, x,
                                               z, biases, mask, reps)
    _check_chain_inputs(stacked, num_layers, R9, t, x, z, biases, mask, reps)
    out = _launch_chain(_chain_library(), stacked, num_layers, R9, t, x, z,
                        biases, mask, reps)
    fused_encoder_chained.launches += 1
    return out


fused_encoder_chained.launches = 0


def _launch_chain(lib, stacked, num_layers, R9, t, x, z, biases, mask, reps):
    """One launch of K5 from ``lib`` on checked CUDA inputs."""
    N, L, F = x.shape
    H = stacked['dims'][0]
    pw, ko = stacked['w_proj'].shape[-1], stacked['w_out'].shape[-2]
    with torch.cuda.device(x.device):
        st = _chain_state(lib, x.device, N, L, H, reps, num_layers, pw, ko)
        out = torch.empty_like(x)
        ptr = lambda a: a.data_ptr()
        w = lambda n: ptr(stacked[n + '_t'])
        err = lib.gablock_chain_forward(
            ptr(x), ptr(R9), ptr(t), ptr(z), ptr(biases), ptr(mask),
            w('w_proj'), pw, ptr(stacked['coef']), w('w_out'), ko,
            ptr(stacked['b_out']), ptr(stacked['ln1']), w('w_m1'),
            w('w_m2'), w('w_m3'), ptr(stacked['b_m']), ptr(stacked['ln2']),
            ptr(out), ptr(st['ws']), ptr(st['counters']), ptr(st['items']),
            st['items'].shape[0], ptr(st['waits']), ptr(st['totals']),
            (st['epoch'] + 1) % 2 ** 32, N, L, H, reps, st['rt'],
            num_layers, st['p2n_rows'],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        _chain_error(lib, err, 'kernel launch')
    st['epoch'] += 1
    return out


def _check_chain_inputs(stacked, num_layers, R9, t, x, z, biases, mask,
                        reps: int):
    """As :func:`_check_inputs`, for the stacked weights and biases."""
    who = 'fused_encoder_chained'
    _require(num_layers >= 1, f'num_layers={num_layers}', who)
    expect = _expected(x, R9, t, z, mask, stacked, reps, (num_layers,), who)
    N, L, _ = x.shape
    H = stacked['dims'][0]
    expect['biases'] = (biases, (N // reps, num_layers, H, L, L),
                        torch.bfloat16)
    _check_tensors(expect, x, who)
    for name, a in (('R9', R9), ('t', t)):   # staged by 16-byte cp.async
        _require(a.data_ptr() % 16 == 0,
                 f'{name} must start on a 16-byte boundary', who)
    missing = [n + '_t' for n in TRANSPOSED if n + '_t' not in stacked]
    _require(not missing, f'the stack lacks {missing} (stack bundles from '
             'build_gablock_weights)', who)
    _check_tensors({n + '_t': (stacked[n + '_t'],
                               (num_layers,) + tuple(stacked[n].shape[:0:-1]),
                               torch.bfloat16) for n in TRANSPOSED}, x, who)


def reset_counts():
    """Zero the kernels' launch counts and the plain versions' call
    counts."""
    gablock_layer.launches = 0
    gablock_layer_reference.calls = 0
    gablock_attention.launches = 0
    gablock_attention_reference.calls = 0
    gablock_p2n.launches = 0
    gablock_p2n_reference.calls = 0
    gablock_gemm.launches = 0
    gablock_gemm_reference.calls = 0
    fused_encoder_chained.launches = 0
    fused_encoder_chained_reference.calls = 0
