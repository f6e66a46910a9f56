"""One GABlock (IPA block) forward: the Hopper kernel, its wrapper and its
plain PyTorch version.

Counterpart of ``ab_opt_tpu/ops/gablock_pallas.py`` (``_gablock_kernel``,
``fused_gablock_layer``, ``build_gablock_weights``). The kernel source is
``csrc/gablock.cu``; it is compiled with ``nvcc`` for ``sm_90a`` into
``_build/`` at first use and loaded with ``ctypes``.

:func:`gablock_layer` dispatches on the device of its input: a CPU tensor
takes :func:`gablock_layer_reference` (the same function in plain PyTorch),
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
* ``dims``: (H, QK, V, P, PV).

Per-complex inputs under trajectory fan-out (row n belongs to complex
n // reps): ``z`` (Nc, L, L, Cz) and ``bias`` (Nc, H, L, L) from
:func:`ab_opt_tpu_torch.nn.ipa.precompute_pair_bias`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

_SRC = build.CSRC_DIR / 'gablock.cu'
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
        return {
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


def build_encoder_weights(encoder, dtype=torch.bfloat16) -> list:
    """Bundles for every block of a GAEncoder: constant across diffusion
    steps, so samplers build them once per sampling call."""
    return [build_gablock_weights(b, dtype) for b in encoder.blocks]


# ------------------------------------------------------------ plain version


def _layernorm(x, ln):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * ln[0] + ln[1]


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
    per_head = lambda g, n: g.reshape(N, L, 3, H, n).permute(0, 1, 3, 2, 4)
    qg = per_head(to_global(qp, HP), P)                        # (N, L, H, 3, P)
    kg = per_head(to_global(kp, HP), P)
    vg = per_head(to_global(vp, HPV), PV)

    coef = wb['coef'].to(f32)                                  # (H,)
    sq_q = qg.square().sum((3, 4))                             # (N, L, H)
    sq_k = kg.square().sum((3, 4))
    ones = torch.ones_like(sq_q)
    qa = rnd(torch.cat([
        q.reshape(N, L, H, QK) / math.sqrt(3.0 * QK),
        (-2.0 * coef[:, None]) * qg.reshape(N, L, H, 3 * P),
        (coef * sq_q)[..., None], (coef * ones)[..., None]], -1))
    ka = rnd(torch.cat([k.reshape(N, L, H, QK), kg.reshape(N, L, H, 3 * P),
                        ones[..., None], sq_k[..., None]], -1))
    vv = rnd(torch.cat([v.reshape(N, L, H, V), vg.reshape(N, L, H, 3 * PV)],
                       -1))

    logits = torch.einsum('nihd,njhd->nhij', qa, ka)
    logits = (logits.reshape(Nc, reps, H, L, L)
              + bias.to(f32)[:, None]).reshape(N, H, L, L)
    alpha = rnd(torch.softmax(logits, dim=-1))
    out = rnd(torch.einsum('nhij,njhd->nihd', alpha, vv))      # (N, L, H, .)
    p2n = rnd(torch.einsum('crhij,cijd->crihd',
                           alpha.reshape(Nc, reps, H, L, L), z.to(f32)))
    p2n = p2n.reshape(N, L, -1)

    node = out[..., :V].reshape(N, L, H * V)
    og = out[..., V:].reshape(N, L, H, 3, PV).permute(0, 1, 3, 2, 4)
    loc = torch.einsum('nldc,nldk->nlck', Rm,
                       og.reshape(N, L, 3, HPV) - tt)          # R^T (g - t)
    ss = loc.square().sum(2)
    dist = torch.sqrt(ss + 1e-12)
    dirn = loc / (torch.sqrt(ss + 1e-8) + 1e-4)[:, :, None]
    feat = torch.cat([p2n, node, loc.reshape(N, L, -1), dist,
                      dirn.reshape(N, L, -1)], -1)

    y = (mm(feat, wb['w_out']) + wb['b_out']) * mask.to(f32)[..., None]
    x1 = _layernorm(x + y, wb['ln1'])
    h1 = torch.relu(mm(x1, wb['w_m1']) + wb['b_m'][0])
    h2 = torch.relu(mm(h1, wb['w_m2']) + wb['b_m'][1])
    h3 = mm(h2, wb['w_m3']) + wb['b_m'][2]
    return _layernorm(x1 + h3, wb['ln2'])


gablock_layer_reference.calls = 0


# ------------------------------------------------------------ the kernel


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(
        build.build_sources([_SRC], build.BUILD_DIR)[str(_SRC)]['path'])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gablock_workspace_bytes.argtypes = [I, I, I, I, I]
    lib.gablock_workspace_bytes.restype = ctypes.c_size_t
    lib.gablock_forward.argtypes = ([P] * 7 + [I] + [P] * 2 + [I] + [P] * 9
                                    + [I] * 4 + [P])
    lib.gablock_forward.restype = I
    lib.gablock_error_string.argtypes = [I]
    lib.gablock_error_string.restype = ctypes.c_char_p
    return lib


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f'gablock_layer: {msg}')


def _check_inputs(x, R9, t, z, bias, mask, wb, reps: int):
    """Raise on anything the kernel does not take (shapes, dtypes,
    contiguity, then device)."""
    H, QK, V, P, PV = wb['dims']
    _require((QK, V, P, PV) == (32, 32, 8, 8),
             f'head geometry {wb["dims"]} (kernel takes QK=V=32, P=PV=8)')
    _require(H % 4 == 0, f'H={H} must be a multiple of 4')
    _require(x.dim() == 3, 'x must be (N, L, F)')
    N, L, F = x.shape
    _require(F == 128, f'node width {F} (kernel takes 128)')
    _require(L % 16 == 0 and 16 <= L <= 256, f'L={L} (multiple of 16, <=256)')
    _require(reps >= 1 and N % reps == 0, f'reps={reps} must divide N={N}')
    Nc = N // reps
    f32, bf16 = torch.float32, torch.bfloat16
    ko = H * (64 + V + 7 * PV)
    expect = {
        'x': (x, (N, L, F), f32), 'R9': (R9, (N, L, 9), f32),
        't': (t, (N, L, 3), f32), 'mask': (mask, (N, L), f32),
        'z': (z, (Nc, L, L, 64), bf16), 'bias': (bias, (Nc, H, L, L), bf16),
        'w_out': (wb['w_out'], (ko, F), bf16),
        'b_out': (wb['b_out'], (F,), f32), 'coef': (wb['coef'], (H,), f32),
        'ln1': (wb['ln1'], (2, F), f32), 'ln2': (wb['ln2'], (2, F), f32),
        'w_m1': (wb['w_m1'], (F, F), bf16), 'w_m2': (wb['w_m2'], (F, F), bf16),
        'w_m3': (wb['w_m3'], (F, F), bf16), 'b_m': (wb['b_m'], (3, F), f32),
    }
    pw = wb['w_proj'].shape[-1]
    expect['w_proj'] = (wb['w_proj'], (F, pw), bf16)
    _require(pw % 128 == 0 and pw >= H * 168, f'w_proj width {pw}')
    for name, (a, shape, dtype) in expect.items():
        _require(a.dtype == dtype, f'{name} dtype {a.dtype}, expected {dtype}')
        _require(tuple(a.shape) == shape,
                 f'{name} shape {tuple(a.shape)}, expected {shape}')
        _require(a.is_contiguous(), f'{name} must be contiguous')
    for name, (a, _, _) in expect.items():
        _require(a.is_cuda and a.device == x.device,
                 f'{name} must lie on the CUDA device of x, not {a.device}')


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
    lib = _library()
    N, L, F = x.shape
    H = wb['dims'][0]
    pw, ko = wb['w_proj'].shape[1], wb['w_out'].shape[0]
    with torch.cuda.device(x.device):
        ws = torch.empty(lib.gablock_workspace_bytes(N, L, H, pw, ko),
                         dtype=torch.uint8, device=x.device)
        out = torch.empty_like(x)
        ptr = lambda a: a.data_ptr()
        err = lib.gablock_forward(
            ptr(x), ptr(R9), ptr(t), ptr(z), ptr(bias), ptr(mask),
            ptr(wb['w_proj']), pw, ptr(wb['coef']), ptr(wb['w_out']), ko,
            ptr(wb['b_out']), ptr(wb['ln1']), ptr(wb['w_m1']),
            ptr(wb['w_m2']), ptr(wb['w_m3']), ptr(wb['b_m']),
            ptr(wb['ln2']), ptr(out), ptr(ws), N, L, H, reps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.gablock_error_string(err).decode()
        raise RuntimeError(f'gablock kernel launch failed: CUDA error {err} '
                           f'({msg})')
    gablock_layer.launches += 1
    return out


gablock_layer.launches = 0


def reset_counts():
    """Zero the kernel's launch count and the plain version's call count."""
    gablock_layer.launches = 0
    gablock_layer_reference.calls = 0
