"""IPA attention forward (K2), backward (K3) and the sampling forward with
the pair aggregation (K4): the Hopper kernels, their wrappers, their plain
PyTorch versions and the autograd function that joins K2/K3 for training.

Counterpart of ``ab_opt_tpu/ops/ipa_pallas.py``: ``_attention_fwd_call``
(``_fwd_kernel``), ``_attention_bwd_call`` (``_bwd_kernel``),
``_attention_fwd_p2n_call`` (``_fwd_p2n_kernel``), the custom VJP of
``_fused_attention`` and ``p2n_aggregate``. The kernel source is
``csrc/ipa_attention.cu``, compiled at first use (see :mod:`.build`).

The JAX layout at every public function, so tests feed both the same arrays
(per-head 64-wide slots):

* ``qa``, ``ka`` (N, L, H*64): augmented queries (pre-scaled) and keys;
* ``vvp`` (N, L, H*64): [values | value points, planar | zero pad];
* ``bias`` (N // reps, H, L, L): pair bias, pre-scaled, column mask folded
  in; trajectory n reads its complex's block n // reps;
* forward outputs ``out`` (N, L, H*64) and ``alphas`` (N, H, L, L), in the
  input dtype;
* K4: ``z`` (N // reps, L, L, Cz) per complex, outputs ``out`` and ``p2n``
  (N, L, H, Cz) in the input dtype, no alphas.

:func:`ipa_attention_fwd`, :func:`ipa_attention_bwd` and
:func:`ipa_attention_fwd_p2n` dispatch on the device of their input: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (float32
or bfloat16, L a multiple of 16 up to 512) or raises. There is no
fallback. On the card K2 and K3 take one of two routes, named by
:func:`attention_plan`: for bfloat16 up to L = 256 (the training path) K2
is K1's replica-group attention tile with alpha in K2's layout and K3 one
launch of a thread-block cluster on the tensor cores; float32, and
bfloat16 past L = 256, take the CUDA-core tiles (K3 as two launches). K4
is forward-only, as on the TPU: a tensor that requires a gradient raises on
any device. On the card K4 takes one of two routes, named by
:func:`fwd_p2n_plan`: K1's replica-group attention tile for bfloat16 up to
L = 256 with Cz = 64 and H a multiple of 4, the CUDA-core tiles for every
other shape within their limits (H up to 16, Cz a multiple of 4 up to 64);
any other shape raises. Counters: ``.launches`` on the three wrappers (one
per call, whatever the number of internal launches), and ``.calls`` on the
plain versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SLOT = 64       # per-head width of qa / ka / vvp
MAX_L = 512
P2N_MAX_HEADS = 16     # K4 on the CUDA cores: H * Cz <= 1024 a query row
P2N_MAX_CZ = 64
TILE_MAX_L = 256       # K4 on K1's attention tile: bf16, L <= 256, Cz = 64
TILE_CZ = 64
SMEM_BLOCK = 232448    # shared memory a block may have on sm_90
_SRC = build.CSRC_DIR / 'ipa_attention.cu'
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions


def _heads(a):
    N, L, HD = a.shape
    return a.reshape(N, L, HD // SLOT, SLOT).to(torch.float32)


def _attention_reference(qa, ka, vvp, bias, reps: int):
    """(out, alphas) of the forward: logits and softmax in f32, alpha
    rounded to the input dtype before the value product (as the TPU kernel
    does)."""
    dt, f32 = qa.dtype, torch.float32
    N, L, HD = qa.shape
    H = HD // SLOT
    logits = torch.einsum('nihd,njhd->nhij', _heads(qa), _heads(ka))
    logits = (logits.reshape(N // reps, reps, H, L, L)
              + bias.to(f32)[:, None]).reshape(N, H, L, L)
    alphas = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum('nhij,njhd->nihd', alphas.to(f32), _heads(vvp))
    return out.reshape(N, L, HD).to(dt), alphas


def ipa_attention_fwd_reference(qa, ka, vvp, bias, reps: int = 1):
    """softmax(qa.ka + bias[n // reps]) and alpha.vvp in plain PyTorch.
    Returns (out, alphas)."""
    ipa_attention_fwd_reference.calls += 1
    return _attention_reference(qa, ka, vvp, bias, reps)


def ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps: int = 1):
    """K4's function in plain PyTorch: the forward's ``out`` and
    p2n[n, i, h] = sum_j alpha[n, h, i, j] z[n // reps, i, j], both products
    from the one alpha rounded to the input dtype, accumulated in f32.
    Returns (out (N, L, H*64), p2n (N, L, H, Cz))."""
    ipa_attention_fwd_p2n_reference.calls += 1
    out, alphas = _attention_reference(qa, ka, vvp, bias, reps)
    N, H, L, _ = alphas.shape
    Cz = z.shape[-1]
    p2n = torch.einsum('crhij,cijd->crihd',
                       alphas.to(torch.float32).reshape(N // reps, reps, H, L, L),
                       z.to(torch.float32))
    return out, p2n.reshape(N, L, H, Cz).to(qa.dtype)


def ipa_attention_bwd_reference(qa, ka, vvp, alphas, dout, dalphas):
    """The VJP of the forward from its saved alphas, in plain PyTorch (f32
    math): returns (dqa, dka, dvvp, dbias) in the input dtype, dbias per
    trajectory (N, H, L, L); the caller sums it over replicas."""
    ipa_attention_bwd_reference.calls += 1
    dt, f32 = qa.dtype, torch.float32
    N, L, HD = qa.shape
    alpha = alphas.to(f32)
    do = _heads(dout)
    dal = torch.einsum('nihd,njhd->nhij', do, _heads(vvp)) + dalphas.to(f32)
    tmp = dal * alpha
    dlog = tmp - alpha * tmp.sum(-1, keepdim=True)
    flat = lambda a: a.reshape(N, L, HD).to(dt)
    return (flat(torch.einsum('nhij,njhd->nihd', dlog, _heads(ka))),
            flat(torch.einsum('nhij,nihd->njhd', dlog, _heads(qa))),
            flat(torch.einsum('nhij,nihd->njhd', alpha, do)),
            dlog.to(dt))


ipa_attention_fwd_reference.calls = 0
ipa_attention_bwd_reference.calls = 0
ipa_attention_fwd_p2n_reference.calls = 0


# ------------------------------------------------------- K2, K3, K4: plans
# The same arithmetic as the source's shared-memory and grid plans
# (csrc/ipa_attention.cu, csrc/k1_tiles.cuh); phases 4 and 7 of
# chip_smoke.py and card tests hold the two against each other.

_KLD = SLOT + 8            # pitch of a staged 64-wide bf16 row
_CC_TK, _CC_TLD = 64, SLOT + 1
_SMEM_SM, _SMEM_RESERVED = 233472, 1024
P2N_M = 128                # alpha rows of a p2n block
P2N_BLOCK_ROWS = 4         # query rows of a p2n block, at most


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cc_smem(tq: int, L: int, H: int, tsize: int) -> int:
    return (((tq + _CC_TK) * _CC_TLD + tq * (L + 1)) * 4
            + H * tq * L * tsize)


def _cc_rows(L: int, H: int, tsize: int) -> int:
    for blocks in (2, 1):
        for tq in (32, 16, 8, 4):
            smem = _cc_smem(tq, L, H, tsize)
            if (smem <= SMEM_BLOCK
                    and blocks * (smem + _SMEM_RESERVED) <= _SMEM_SM):
                return tq
    return 0


TILE_ROWS = 64             # a tile block's query rows (K2, K3), then key rows (K3)


def _tile_smem(L: int, qt: int, ns: int) -> int:
    """Shared memory of K1's attention tile at L: the bias rows of qt query
    rows and ns stages of [K | V | Q] (AttnPlan::smem)."""
    return qt * (L + 8) * 2 + ns * (2 * L + qt) * _KLD * 2


def _replica_group(reps: int) -> int:
    """Replicas a tile block serves (they share its bias rows): the largest
    of 4, 2 and 1 that divides reps, as K1 and K4 pick them."""
    return next(r for r in (4, 2, 1) if reps % r == 0)


def _launch(name, grid, threads, smem, cluster=1) -> dict:
    return {'name': name, 'grid': grid, 'threads': threads,
            'cluster': cluster, 'smem': smem}


def attention_plan(dtype, N: int, L: int, H: int, reps: int = 1) -> dict:
    """K2's and K3's launch plans, a pure function of the shapes: ``{'fwd':
    ..., 'bwd': ...}``, each with its ``route`` and, per launch, its grid,
    threads, cluster size and shared memory (cached per shape: not to be
    modified). Raises ValueError for a shape neither route takes.

    ``'tile'`` (bfloat16, L a multiple of 16 up to 256): K2 is K1's
    attention tile with alpha in K2's layout, a block per (64 query rows,
    head, ``rt`` replicas), four warps and one stage up to L = 128, two past
    it. K3 is one launch of a ``cluster`` of ceil(L / 64) blocks per
    (trajectory, head), grid (cluster, H, N): block r takes query rows 64 r
    .. in its first phase and key rows 64 r .. in its second.
    ``'cuda_cores'`` (float32, or bfloat16 past L = 256): 32 query rows a
    block, and K3's second launch 32 keys a block."""
    return {'fwd': _fwd_plan(dtype, N, L, H, reps),
            'bwd': _bwd_plan(dtype, N, L, H)}


def _plan_shapes(dtype, N: int, L: int, reps: int) -> bool:
    """Raise on a shape neither route takes; True on the tile route."""
    _require(dtype in _DTYPES, f'dtype {dtype} (float32 or bfloat16)')
    _require(L % 16 == 0 and 16 <= L <= MAX_L,
             f'L={L} (multiple of 16, at most {MAX_L})')
    _require(reps >= 1 and N % reps == 0, f'reps={reps} must divide N={N}')
    return dtype == torch.bfloat16 and L <= TILE_MAX_L


def _cc_rows_launch(name: str, N: int, L: int, H: int) -> dict:
    return _launch(name, (_cdiv(L, 32), H, N), 256,
                   ((32 + _CC_TK) * _CC_TLD + 32 * (L + 1)) * 4)


@functools.lru_cache(maxsize=1024)
def _fwd_plan(dtype, N: int, L: int, H: int, reps: int) -> dict:
    if _plan_shapes(dtype, N, L, reps):
        rt = _replica_group(reps)
        return {'route': 'tile', 'query_rows': TILE_ROWS, 'rt': rt,
                'launches': [_launch(
                    'k2_tile', (_cdiv(L, TILE_ROWS), H, N // rt),
                    TILE_ROWS // 16 * 32,
                    _tile_smem(L, TILE_ROWS, 2 if L > 128 else 1))]}
    return {'route': 'cuda_cores', 'query_rows': 32, 'rt': 1,
            'launches': [_cc_rows_launch('fwd', N, L, H)]}


@functools.lru_cache(maxsize=1024)
def _bwd_plan(dtype, N: int, L: int, H: int) -> dict:
    if _plan_shapes(dtype, N, L, 1):
        c = _cdiv(L, TILE_ROWS)
        return {'route': 'tile', 'rows': TILE_ROWS,
                'launches': [_launch('k3_tile', (c, H, N), 128,
                                     6 * L * _KLD * 2, cluster=c)]}
    return {'route': 'cuda_cores', 'rows': 32,
            'launches': [_cc_rows_launch('rows', N, L, H), _launch(
                'cols', (_cdiv(L, 32), H, N), 256,
                ((32 + 2 * 32) * _CC_TLD + 2 * 32 * 33) * 4)]}


def _p2n_ald(L: int) -> int:
    return max(L, TILE_CZ) + 8


def _attn_plan(L: int) -> tuple:
    """K1's attention tile as S1 and K4 run it at L (AttnLean up to 128, one
    stage so that two blocks share an SM; AttnLarge past it): (query rows,
    warps, stages, smem)."""
    qt, qw, ns = (128, 8, 1) if L <= 128 else (64, 4, 2)
    return qt, qw, ns, _tile_smem(L, qt, ns)


def _p2n_stages(L: int) -> tuple:
    """K4's p2n ring at L: (stages, bytes a stage), two stages where two
    blocks of them fit an SM, else one."""
    sb = (L * _KLD + P2N_M * _p2n_ald(L)) * 2
    return (2 if 2 * (2 * sb + _SMEM_RESERVED) <= _SMEM_SM else 1), sb


def fwd_p2n_plan(dtype, N: int, L: int, H: int, Cz: int, reps: int,
                 sms: int = 132) -> dict:
    """K4's launch plan on the card, a pure function of the shapes: which
    route and, per launch, its grid, threads and shared memory. Raises
    ValueError for a shape neither route takes.

    ``'tile'`` (bf16, L a multiple of 16 up to 256, Cz = 64, H a multiple
    of 4): K1's attention tile in blocks of ``rt`` replicas, alpha in K1's
    layout into a workspace of ``workspace_bytes``, then p2n in blocks of
    128 alpha rows and ``p2n_rows`` query rows (fewer where two blocks an
    SM, ``sms`` of them, would not be covered). ``'cuda_cores'`` (float32,
    bf16 past L = 256, and bf16 with another Cz or H, as the JAX kernel
    takes any): K2's f32 tiles, ``query_rows`` a block."""
    _require(dtype in _DTYPES, f'dtype {dtype} (float32 or bfloat16)')
    _require(L % 16 == 0 and 16 <= L <= MAX_L,
             f'L={L} (multiple of 16, at most {MAX_L})')
    _require(reps >= 1 and N % reps == 0, f'reps={reps} must divide N={N}')
    Nc = N // reps
    if (dtype == torch.bfloat16 and L <= TILE_MAX_L and Cz == TILE_CZ
            and H >= 4 and H % 4 == 0):
        rt = _replica_group(reps)
        qt, qw, _, smem = _attn_plan(L)
        PMB = _cdiv(reps * H, P2N_M)
        rows = max(1, min(P2N_BLOCK_ROWS, Nc * PMB * L // (2 * sms)))
        stages, sb = _p2n_stages(L)
        return {
            'route': 'tile', 'rt': rt, 'query_rows': qt, 'p2n_rows': rows,
            'p2n_stages': stages, 'workspace_bytes': Nc * L * reps * H * L * 2,
            'launches': [
                {'name': 'attention', 'grid': (_cdiv(L, qt), H, N // rt),
                 'threads': 32 * qw, 'smem': smem},
                {'name': 'p2n', 'grid': (PMB, _cdiv(L, rows), Nc),
                 'threads': 256, 'smem': stages * sb}]}
    _require(H <= P2N_MAX_HEADS, f'H={H} (at most {P2N_MAX_HEADS} heads)')
    _require(Cz % 4 == 0 and 4 <= Cz <= P2N_MAX_CZ,
             f'Cz={Cz} (a multiple of 4, at most {P2N_MAX_CZ})')
    tsize = 4 if dtype == torch.float32 else 2
    tq = _cc_rows(L, H, tsize)
    _require(tq > 0, f'no CUDA-core tile fits L={L}, H={H}')
    return {'route': 'cuda_cores', 'query_rows': tq,
            'launches': [{'name': 'cuda_cores', 'grid': (_cdiv(L, tq), N),
                          'threads': 256,
                          'smem': _cc_smem(tq, L, H, tsize)}]}


# ------------------------------------------------------------ the kernels


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(
        build.build_sources([_SRC], build.BUILD_DIR)[str(_SRC)]['path'])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ipa_attention_fwd.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.ipa_attention_fwd.restype = I
    lib.ipa_attention_bwd.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.ipa_attention_bwd.restype = I
    lib.ipa_attention_fwd_tile.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.ipa_attention_fwd_tile.restype = I
    lib.ipa_attention_bwd_tile.argtypes = [P] * 10 + [I] * 3 + [P]
    lib.ipa_attention_bwd_tile.restype = I
    lib.ipa_attention_plan.argtypes = [I] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.ipa_attention_plan.restype = I
    lib.ipa_attention_fwd_p2n.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.ipa_attention_fwd_p2n.restype = I
    lib.ipa_attention_fwd_p2n_tile.argtypes = [I] * 3
    lib.ipa_attention_fwd_p2n_tile.restype = I
    lib.ipa_attention_fwd_p2n_tiles.argtypes = [P] * 8 + [I] * 6 + [P]
    lib.ipa_attention_fwd_p2n_tiles.restype = I
    lib.ipa_attention_fwd_p2n_tile_plan.argtypes = [
        I, ctypes.POINTER(ctypes.c_longlong)]
    lib.ipa_attention_fwd_p2n_tile_plan.restype = I
    lib.ipa_attention_error_string.argtypes = [I]
    lib.ipa_attention_error_string.restype = ctypes.c_char_p
    return lib


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f'ipa_attention: {msg}')


def _check(named, reps: int = 1):
    """Raise on anything the kernels do not take: ``named`` maps names to
    tensors; the first is an (N, L, H*64) operand that fixes the shapes."""
    first = next(iter(named.values()))
    _require(first.dim() == 3, 'operands must be (N, L, H*64)')
    N, L, HD = first.shape
    _require(HD % SLOT == 0 and HD > 0, f'last dim {HD} is not H*{SLOT}')
    _require(L % 16 == 0 and 16 <= L <= MAX_L,
             f'L={L} (multiple of 16, at most {MAX_L})')
    _require(reps >= 1 and N % reps == 0, f'reps={reps} must divide N={N}')
    _require(first.dtype in _DTYPES,
             f'dtype {first.dtype} (float32 or bfloat16)')
    H = HD // SLOT
    shapes = {'bias': (N // reps, H, L, L), 'alphas': (N, H, L, L),
              'dalphas': (N, H, L, L)}
    if 'z' in named:
        shapes['z'] = (N // reps, L, L, named['z'].shape[-1])
    for name, a in named.items():
        want = shapes.get(name, (N, L, HD))
        _require(tuple(a.shape) == want,
                 f'{name} shape {tuple(a.shape)}, expected {want}')
        _require(a.dtype == first.dtype,
                 f'{name} dtype {a.dtype}, expected {first.dtype}')
        _require(a.is_contiguous(), f'{name} must be contiguous')
    for name, a in named.items():
        _require(a.is_cuda and a.device == first.device,
                 f'{name} must lie on the CUDA device of the operands, '
                 f'not {a.device}')
    return N, L, H


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _library().ipa_attention_error_string(err).decode()
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err} '
                           f'({msg})')


def _launch_fwd(qa, ka, vvp, bias, reps, N, L, H, plan):
    """K2's launch on checked CUDA operands of shapes (N, L, H) by ``plan``."""
    lib = _library()
    with torch.cuda.device(qa.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(qa)
        alphas = torch.empty((N, H, L, L), dtype=qa.dtype, device=qa.device)
        ptrs = [a.data_ptr() for a in (qa, ka, vvp, bias, out, alphas)]
        if plan['route'] == 'tile':
            err = lib.ipa_attention_fwd_tile(*ptrs, N, L, H, reps, stream)
        else:
            err = lib.ipa_attention_fwd(*ptrs, N, L, H, reps,
                                        _DTYPES[qa.dtype], stream)
    _raise_on(err, 'ipa_attention_fwd')
    return out, alphas


def _launch_bwd(qa, ka, vvp, alphas, dout, dalphas, N, L, H, plan):
    """K3's launches on checked CUDA operands of shapes (N, L, H) by
    ``plan``."""
    lib = _library()
    with torch.cuda.device(qa.device):
        stream = torch.cuda.current_stream().cuda_stream
        dqa, dka, dvvp = (torch.empty_like(qa) for _ in range(3))
        dbias = torch.empty_like(alphas)
        ptrs = [a.data_ptr() for a in (qa, ka, vvp, alphas, dout, dalphas,
                                       dqa, dka, dvvp, dbias)]
        if plan['route'] == 'tile':
            err = lib.ipa_attention_bwd_tile(*ptrs, N, L, H, stream)
        else:
            rowsum = torch.empty((N, H, L), dtype=torch.float32,
                                 device=qa.device)
            err = lib.ipa_attention_bwd(*ptrs, rowsum.data_ptr(), N, L, H,
                                        _DTYPES[qa.dtype], stream)
    _raise_on(err, 'ipa_attention_bwd')
    return dqa, dka, dvvp, dbias


def fwd_on_route(qa, ka, vvp, bias, reps: int, plan: dict):
    """K2's launch on CUDA operands by ``plan`` (``attention_plan(...)
    ['fwd']``, or another route's plan for a side-by-side timing): (out,
    alphas). Checks like the wrapper; counts nothing."""
    N, L, H = _check({'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias}, reps)
    _require(plan['route'] == 'cuda_cores' or qa.dtype == torch.bfloat16,
             'the tile route takes bfloat16')
    return _launch_fwd(qa, ka, vvp, bias, reps, N, L, H, plan)


def bwd_on_route(qa, ka, vvp, alphas, dout, dalphas, plan: dict):
    """K3's launches on CUDA operands by ``plan`` (``attention_plan(...)
    ['bwd']``, or another route's plan): (dqa, dka, dvvp, dbias). Checks
    like the wrapper; counts nothing."""
    N, L, H = _check({'qa': qa, 'ka': ka, 'vvp': vvp, 'alphas': alphas,
                      'dout': dout, 'dalphas': dalphas})
    _require(plan['route'] == 'cuda_cores' or qa.dtype == torch.bfloat16,
             'the tile route takes bfloat16')
    return _launch_bwd(qa, ka, vvp, alphas, dout, dalphas, N, L, H, plan)


def ipa_attention_fwd(qa, ka, vvp, bias, reps: int = 1):
    """K2: (out, alphas). A CPU ``qa`` takes the plain version; any other
    device launches the kernel of :func:`attention_plan`'s route (one count
    on ``.launches``) or raises."""
    if qa.device.type == 'cpu':
        return ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
    N, L, H = _check({'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias}, reps)
    got = _launch_fwd(qa, ka, vvp, bias, reps, N, L, H,
                      _fwd_plan(qa.dtype, N, L, H, reps))
    ipa_attention_fwd.launches += 1
    return got


def ipa_attention_bwd(qa, ka, vvp, alphas, dout, dalphas):
    """K3: (dqa, dka, dvvp, dbias per trajectory). Dispatches like
    :func:`ipa_attention_fwd`; one count on ``.launches`` per call (one
    launch on the tile route, two on the CUDA cores)."""
    if qa.device.type == 'cpu':
        return ipa_attention_bwd_reference(qa, ka, vvp, alphas, dout, dalphas)
    N, L, H = _check({'qa': qa, 'ka': ka, 'vvp': vvp, 'alphas': alphas,
                      'dout': dout, 'dalphas': dalphas})
    got = _launch_bwd(qa, ka, vvp, alphas, dout, dalphas, N, L, H,
                      _bwd_plan(qa.dtype, N, L, H))
    ipa_attention_bwd.launches += 1
    return got


def source_attention_plan(N: int, L: int, H: int, reps: int, dtype) -> dict:
    """The source's own plan of K2 and K3 (``ipa_attention_plan``), for the
    check against :func:`attention_plan`: ``{'fwd': (route, launches),
    'bwd': ...}``, each launch (grid, threads, cluster, smem)."""
    out = (ctypes.c_longlong * 28)()
    _raise_on(_library().ipa_attention_plan(N, L, H, reps, _DTYPES[dtype],
                                            out), 'ipa_attention_plan')
    got = {}
    for k, key in enumerate(('fwd', 'bwd')):
        o = list(out[14 * k:14 * k + 14])
        launches = [(tuple(o[2 + 6 * i:5 + 6 * i]), o[5 + 6 * i],
                     o[6 + 6 * i], o[7 + 6 * i]) for i in range(o[1])]
        got[key] = ('tile' if o[0] else 'cuda_cores', launches)
    return got


def plan_launches(plan: dict) -> dict:
    """:func:`attention_plan`'s plan in :func:`source_attention_plan`'s
    form."""
    return {k: (p['route'], [(tuple(l['grid']), l['threads'], l['cluster'],
                              l['smem']) for l in p['launches']])
            for k, p in plan.items()}


def source_plan(L: int) -> list:
    """The source's own plan of the tile route at L, for the check against
    :func:`fwd_p2n_plan`: [attention smem, p2n smem, attention query rows,
    p2n stages]."""
    out = (ctypes.c_longlong * 4)()
    _raise_on(_library().ipa_attention_fwd_p2n_tile_plan(L, out),
              'ipa_attention_fwd_p2n_tile_plan')
    return list(out)


# The tile route's alpha workspace per (device, bytes), kept from call to
# call (one stream, as a sampler's steps run).
_P2N_WORKSPACE: dict = {}


def _launch_p2n(qa, ka, vvp, bias, z, reps, plan):
    """K4's launches on checked CUDA operands by ``plan``
    (:func:`fwd_p2n_plan`); returns (out, p2n)."""
    lib = _library()
    N, L, HD = qa.shape
    H, Cz = HD // SLOT, z.shape[-1]
    stream = torch.cuda.current_stream(qa.device).cuda_stream
    with torch.cuda.device(qa.device):
        out = torch.empty_like(qa)
        p2n = torch.empty((N, L, H, Cz), dtype=qa.dtype, device=qa.device)
        ptr = lambda a: a.data_ptr()
        if plan['route'] == 'cuda_cores':
            err = lib.ipa_attention_fwd_p2n(
                ptr(qa), ptr(ka), ptr(vvp), ptr(bias), ptr(z), ptr(out),
                ptr(p2n), N, L, H, Cz, reps, _DTYPES[qa.dtype], stream)
        else:
            key = (str(qa.device), plan['workspace_bytes'])
            alpha = _P2N_WORKSPACE.get(key)
            if alpha is None:
                alpha = torch.empty(plan['workspace_bytes'], dtype=torch.uint8,
                                    device=qa.device)
                _P2N_WORKSPACE[key] = alpha
            err = lib.ipa_attention_fwd_p2n_tiles(
                ptr(qa), ptr(ka), ptr(vvp), ptr(bias), ptr(z), ptr(out),
                ptr(p2n), ptr(alpha), N, L, H, reps, plan['rt'],
                plan['p2n_rows'], stream)
    _raise_on(err, 'ipa_attention_fwd_p2n')
    return out, p2n


def ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps: int = 1):
    """K4: (out, p2n), for sampling. Raises if any input requires a
    gradient (there is no backward). A CPU ``qa`` takes the plain version;
    any other device launches the kernel of :func:`fwd_p2n_plan`'s route
    (one count on ``.launches``) or raises."""
    named = {'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias, 'z': z}
    for name, a in named.items():
        _require(not a.requires_grad,
                 f'{name} requires a gradient: the p2n forward has no '
                 'backward (sampling only)')
    if qa.device.type == 'cpu':
        return ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps)
    _require(qa.dim() == 3 and z.dim() == 4,
             'qa must be (N, L, H*64) and z (N // reps, L, L, Cz)')
    N, L, HD = qa.shape
    plan = fwd_p2n_plan(qa.dtype, N, L, HD // SLOT, z.shape[-1], reps,
                        _sms(qa.device) if qa.is_cuda else 132)
    _check(named, reps)
    got = _launch_p2n(qa, ka, vvp, bias, z, reps, plan)
    ipa_attention_fwd_p2n.launches += 1
    return got


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


ipa_attention_fwd.launches = 0
ipa_attention_bwd.launches = 0
ipa_attention_fwd_p2n.launches = 0


def reset_counts():
    """Zero the kernels' launch counts and the plain versions' call
    counts."""
    ipa_attention_fwd.launches = 0
    ipa_attention_bwd.launches = 0
    ipa_attention_fwd_p2n.launches = 0
    ipa_attention_fwd_reference.calls = 0
    ipa_attention_bwd_reference.calls = 0
    ipa_attention_fwd_p2n_reference.calls = 0


# ------------------------------------------------------------ autograd


class IPAAttention(torch.autograd.Function):
    """(out, alphas) = attention(qa, ka, vvp, bias) with the backward of the
    TPU kernel's custom VJP: K3 from the saved alphas, then dbias summed over
    the replicas that share a complex's bias. ``plain`` runs the plain
    versions both ways, whatever the device (the side-by-side check)."""

    @staticmethod
    def forward(ctx, qa, ka, vvp, bias, reps: int, plain: bool):
        fwd = ipa_attention_fwd_reference if plain else ipa_attention_fwd
        out, alphas = fwd(qa, ka, vvp, bias, reps)
        ctx.save_for_backward(qa, ka, vvp, alphas)
        ctx.reps, ctx.plain = reps, plain
        return out, alphas

    @staticmethod
    def backward(ctx, dout, dalphas):
        qa, ka, vvp, alphas = ctx.saved_tensors
        bwd = ipa_attention_bwd_reference if ctx.plain else ipa_attention_bwd
        dqa, dka, dvvp, dbias = bwd(qa, ka, vvp, alphas, dout.contiguous(),
                                    dalphas.contiguous())
        if ctx.reps != 1:
            N, H, L, _ = dbias.shape
            dbias = dbias.reshape(N // ctx.reps, ctx.reps, H, L, L).sum(1)
        return dqa, dka, dvvp, dbias, None, None


def ipa_attention(qa, ka, vvp, bias, reps: int = 1):
    """Differentiable (out, alphas): the K2/K3 kernels for CUDA tensors,
    their plain versions for CPU tensors."""
    return IPAAttention.apply(qa, ka, vvp, bias, reps, False)


def ipa_attention_plain(qa, ka, vvp, bias, reps: int = 1):
    """The same function through the plain versions on any device."""
    return IPAAttention.apply(qa, ka, vvp, bias, reps, True)


def p2n_aggregate(alphas, z, reps: int = 1):
    """Value-from-pair aggregation sum_j alpha[n,h,i,j] z[n // reps,i,j,c]
    -> (N, L, H, Cz); with ``reps`` > 1 the replicas of a complex share z and
    are folded into one product of M = reps * H rows."""
    N, H, L, _ = alphas.shape
    if reps == 1:
        return torch.einsum('nhij,nijc->nihc', alphas, z)
    a = alphas.reshape(N // reps, reps * H, L, L)
    p2n = torch.einsum('nkij,nijc->nikc', a, z)              # (Nc, L, rH, Cz)
    Cz = z.shape[-1]
    return (p2n.reshape(N // reps, L, reps, H, Cz)
            .permute(0, 2, 1, 3, 4).reshape(N, L, H, Cz))
