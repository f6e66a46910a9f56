"""The attention-variant harness (S1-S3): three Hopper kernels that compute
the IPA attention forward in different ways, their wrappers and their plain
versions.

Counterpart of ``scripts/micro_kernel_variants.py``: ``v1_call``
(``_v1_kernel``, phase-separated; ``store_alphas`` gives v1 or v3),
``v2_call`` (``_v2_kernel``, the heads batched) and ``v4_call``
(``_v4_kernel``, v3 plus the pair aggregation). In the JAX package they
compute exactly what K2 (``_attention_fwd_call``) and K4
(``_attention_fwd_p2n_call``) compute, so their plain versions are K2's and
K4's, :func:`.ipa_attention.ipa_attention_fwd_reference` and
:func:`.ipa_attention.ipa_attention_fwd_p2n_reference`. The kernel source is
``csrc/attention_variants.cu``, compiled at first use (see :mod:`.build`).
No route of the sampler or the trainer selects these kernels: they exist to
be timed against each other (``utils/micro_attention.py``).

Operands are K2's, in the JAX layout: ``qa``, ``ka``, ``vvp`` (N, L, H*64),
``bias`` (N // reps, H, L, L); S3 also takes ``z`` (N // reps, L, L, Cz).

* S1 runs K1's replica-group attention tile (``csrc/k1_tiles.cuh``, the tile
  of K1's attention launch, :func:`.gablock.gablock_attention`) with alpha
  in K2's (N, H, L, L) layout (v1) or not stored at all (v3), in blocks of
  :func:`.gablock.attention_replicas` replicas.
* S2 walks every head in one block of 64 query rows and ``rt`` replicas:
  a producer warpgroup feeds the heads by TMA, two consumer warpgroups compute
  on ``wgmma`` (:func:`v2_plan`).
* S3 is K4's function in one launch: K1's attention tile pushes each
  alpha row, over distributed shared memory, to the block of its
  thread-block cluster that owns its query row, and that block multiplies
  the cluster's rows by z[c, i] (:func:`v4_plan`); alpha never reaches
  device memory, and o and p2n are K4's
  (:func:`.ipa_attention.ipa_attention_fwd_p2n`, tile route) bit for bit.

Every wrapper refuses an input that requires a gradient (the variants have
no backward), takes the plain version for a CPU ``qa``, and on any other
device launches its kernel or raises; nothing falls back. The card kernels
take bfloat16 only (the script runs them only in bf16) and L a multiple of
16 up to :data:`MAX_L` (256); S3 also Cz a multiple of 16 up to 64 and H
up to 16. ``launches[name]`` counts the kernel launches of ``'v1'``,
``'v3'``, ``'v2'`` and ``'v4'``: one a call each.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from . import ipa_attention as ia
from .gablock import attention_replicas

SLOT = ia.SLOT
MAX_L = 256                # every variant takes L a multiple of 16 up to 256
SMEM_BLOCK = 232448        # shared memory a block may have on sm_90
_SRC = build.CSRC_DIR / 'attention_variants.cu'

launches = {'v1': 0, 'v3': 0, 'v2': 0, 'v4': 0}


def reset_counts():
    """Zero the variants' launch counts and their plain versions' call
    counts (those are K2's and K4's, see :func:`.ipa_attention.reset_counts`)."""
    for k in launches:
        launches[k] = 0
    ia.ipa_attention_fwd_reference.calls = 0
    ia.ipa_attention_fwd_p2n_reference.calls = 0


# --------------------------------------------------------------- the plans
# The same arithmetic as attention_tile_smem(), s3_plan() and s2_plan() in
# the source; a card test and chip_smoke.py phase 11 hold the two against
# each other.


def tile_smem(L: int) -> int:
    """Bytes of shared memory a block of S1 takes: K1's attention tile, the
    bias rows of its query tile and its K / V / Q stages (whatever H)."""
    return ia._attn_plan(L)[3]


S3_MAX_CLUSTER = 8         # blocks of an S3 cluster, at most (portable)
_S3_Z_STAGES = 3           # z[c, i] buffers of the p2n ring
_S3_OLD = 24               # pitch of a warp's 16 x 16 p2n staging tile


def v4_plan(N: int, L: int, H: int, Cz: int, reps: int) -> dict:
    """S3's launch at these shapes: K1's attention tile with 64 query rows,
    128 threads and one stage over ``rt`` replicas (the larger of 2, 1
    dividing reps whose block fits). The ``cluster`` (1, cy, cz) joins cz
    replica groups (the largest divisor of reps / rt up to 8) of cy heads
    (the largest divisor of H with cy cz <= 8): ``rows_per_z`` = cy cz rt
    alpha rows share each z[c, i]. A block holds the gathered alpha rows of
    the query rows it owns (ceil(64 / (cy cz)) of them, ``rows_per_z`` rows
    of L + 8 each, and 16 - ``rows_per_z`` more to end the last 16-row
    tile), one replica's alpha (64 rows of L) and a work region for first
    the attention's bias rows and stage, then three z[c, i] buffers and
    each warp's 16 x 16 staging tile."""
    qt, threads = 64, 128
    attn = ia._tile_smem(L, qt, 1)
    p2n = _S3_Z_STAGES * L * (Cz + 8) * 2 + threads // 32 * 16 * _S3_OLD * 2
    for rt in (2, 1):
        if reps % rt:
            continue
        cz = next(d for d in range(S3_MAX_CLUSTER, 0, -1)
                  if (reps // rt) % d == 0)
        cy = next(d for d in range(S3_MAX_CLUSTER // cz, 0, -1) if H % d == 0)
        m = cy * cz * rt
        g_rows = ia._cdiv(qt, cy * cz) * m + 16 - m
        smem = g_rows * (L + 8) * 2 + qt * L * 2 + max(attn, p2n)
        if smem <= SMEM_BLOCK:
            return {'query_rows': qt, 'threads': threads, 'rt': rt,
                    'cluster': (1, cy, cz), 'rows_per_z': m,
                    'smem': smem, 'grid': (ia._cdiv(L, qt), H, N // rt)}
    raise ValueError(f'attention_variants: no S3 block fits L={L}')


def v4_p2n_writes(N: int, L: int, H: int, Cz: int, reps: int):
    """Every p2n row S3 writes, as the kernel deals them: yields (cluster,
    block, n, i, h), ``block`` its grid index (x, y, z) and ``cluster`` the
    index of its cluster. Block rank p = dy + cy dz of a cluster owns its
    query rows p, p + cy cz, ... of the tile and writes, for each, the
    rows m = p' rt + r that every rank p' pushed into it (head y - y % cy
    + p' % cy, trajectory (z - z % cz + p' // cy) rt + r)."""
    plan = v4_plan(N, L, H, Cz, reps)
    qt, rt = plan['query_rows'], plan['rt']
    _, cy, cz = plan['cluster']
    gx, gy, gz = plan['grid']
    for x in range(gx):
        for y in range(gy):
            for zb in range(gz):
                rank = y % cy + cy * (zb % cz)
                hq, gq = y - y % cy, zb - zb % cz
                for q in range(rank, qt, cy * cz):
                    i = x * qt + q
                    if i >= L:
                        break
                    for m in range(cy * cz * rt):
                        pr = m // rt
                        yield ((x, y // cy, zb // cz), (x, y, zb),
                               (gq + pr // cy) * rt + m % rt, i,
                               hq + pr % cy)


_S2_BOX = 64 * 64 * 2      # one 64 x 64 bf16 TMA box


def v2_plan(N: int, L: int, H: int, reps: int) -> dict:
    """S2's launch at these shapes: a block of 384 threads (two consumer
    warpgroups and the producer's) per (64 query rows, ``rt`` replicas),
    ``rt`` 2 where reps is even, else 1; ``stages`` item stages [Q (64 x
    64) | K | V (Lk x 64 each)], four where they fit, else two, beside two
    bias stages (Lk / 64 boxes of 64 x 64), Lk = L rounded up to 64, 1024
    bytes of alignment slack and 256 of mbarriers."""
    lk = ia._cdiv(L, 64) * 64
    stage = _S2_BOX + 2 * lk * 128
    fixed = 1024 + 2 * (lk // 64) * _S2_BOX + 256
    ns = 4 if fixed + 4 * stage <= SMEM_BLOCK else 2
    rt = 2 if reps % 2 == 0 else 1
    return {'rt': rt, 'stages': ns, 'smem': fixed + ns * stage,
            'threads': 384, 'grid': (ia._cdiv(L, 64), N // rt)}


# ------------------------------------------------------------ the kernels


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(
        build.build_sources([_SRC], build.BUILD_DIR)[str(_SRC)]['path'])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.attention_tile.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.attention_tile.restype = I
    lib.attention_v4.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.attention_v4.restype = I
    lib.attention_v2.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.attention_v2.restype = I
    lib.attention_tile_smem.argtypes = [I]
    lib.attention_tile_smem.restype = ctypes.c_size_t
    lib.attention_v4_plan.argtypes = [I] * 4 + [LL]
    lib.attention_v4_plan.restype = I
    lib.attention_v2_plan.argtypes = [I, I, LL]
    lib.attention_v2_plan.restype = I
    lib.attention_variants_error_string.argtypes = [I]
    lib.attention_variants_error_string.restype = ctypes.c_char_p
    return lib


def source_v4_plan(N: int, L: int, H: int, Cz: int, reps: int) -> dict:
    """S3's plan as the source computes it (builds the library), in
    :func:`v4_plan`'s form."""
    out = (ctypes.c_longlong * 7)()
    _raise_on(_library().attention_v4_plan(L, H, Cz, reps, out), 'S3 plan')
    qt, threads, rt, cy, cz, m, smem = (int(v) for v in out)
    return {'query_rows': qt, 'threads': threads, 'rt': rt,
            'cluster': (1, cy, cz), 'rows_per_z': m, 'smem': smem,
            'grid': (ia._cdiv(L, qt), H, N // rt)}


def source_v2_plan(N: int, L: int, H: int, reps: int) -> dict:
    """S2's plan as the source computes it, in :func:`v2_plan`'s form."""
    out = (ctypes.c_longlong * 3)()
    _raise_on(_library().attention_v2_plan(L, reps, out), 'S2 plan')
    rt, ns, smem = (int(v) for v in out)
    return {'rt': rt, 'stages': ns, 'smem': smem, 'threads': 384,
            'grid': (ia._cdiv(L, 64), N // rt)}


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f'attention_variants: {msg}')


def _no_grad(named):
    for name, a in named.items():
        _require(not a.requires_grad,
                 f'{name} requires a gradient: the attention variants have '
                 'no backward')


def _check(named, reps: int, kind: str):
    """Raise on what the card kernels do not take: bf16 only and L up to
    MAX_L, then K2's shape, contiguity and device checks."""
    qa = named['qa']
    _require(qa.dtype == torch.bfloat16,
             f'dtype {qa.dtype}: the card kernels take bfloat16 only')
    if qa.dim() == 3:
        L = qa.shape[1]
        _require(L <= MAX_L, f'L={L} is past the cap L={MAX_L} of the '
                             f'{kind} kernel')
    return ia._check(named, reps)


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _library().attention_variants_error_string(err).decode()
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err} '
                           f'({msg})')


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


def attention_v1(qa, ka, vvp, bias, reps: int = 1, store_alphas: bool = True):
    """S1: (out, alphas), or ``out`` alone with ``store_alphas=False`` (v3).
    K2's function on K1's attention tile: a block per (query tile, head,
    replica group), logits, softmax and alpha . vvp in registers."""
    named = {'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias}
    _no_grad(named)
    if qa.device.type == 'cpu':
        out, alphas = ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
        return (out, alphas) if store_alphas else out
    N, L, H = _check(named, reps, 'tile')
    name = 'v1' if store_alphas else 'v3'
    lib = _library()
    with torch.cuda.device(qa.device):
        out = torch.empty_like(qa)
        alphas = (torch.empty((N, H, L, L), dtype=qa.dtype, device=qa.device)
                  if store_alphas else None)
        err = lib.attention_tile(
            qa.data_ptr(), ka.data_ptr(), vvp.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if alphas is None else alphas.data_ptr(), N,
            L, H, reps, attention_replicas(reps), _stream(qa))
    _raise_on(err, f'attention {name}')
    launches[name] += 1
    return (out, alphas) if store_alphas else out


def attention_v2(qa, ka, vvp, bias, reps: int = 1):
    """S2: (out, alphas), K2's function with every head walked in one block
    of 64 query rows (:func:`v2_plan`): TMA-fed head stages, logits and
    alpha . vvp by ``wgmma``."""
    named = {'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias}
    _no_grad(named)
    if qa.device.type == 'cpu':
        return ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
    N, L, H = _check(named, reps, 'v2')
    lib = _library()
    with torch.cuda.device(qa.device):
        out = torch.empty_like(qa)
        alphas = torch.empty((N, H, L, L), dtype=qa.dtype, device=qa.device)
        err = lib.attention_v2(
            qa.data_ptr(), ka.data_ptr(), vvp.data_ptr(), bias.data_ptr(),
            out.data_ptr(), alphas.data_ptr(), N, L, H, reps, _stream(qa))
    _raise_on(err, 'attention v2')
    launches['v2'] += 1
    return out, alphas


def attention_v4(qa, ka, vvp, bias, z, reps: int = 1):
    """S3: (out, p2n), K4's function in one launch with no alpha in device
    memory (:func:`v4_plan`): p2n[n, i, h] = sum_j alpha[n, h, i, j]
    z[n // reps, i, j], the alpha rows of query row i collected in one
    block of a cluster, which reads z[n // reps, i] once."""
    named = {'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias, 'z': z}
    _no_grad(named)
    if qa.device.type == 'cpu':
        return ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps)
    H, Cz = qa.shape[-1] // SLOT, z.shape[-1]
    _require(H <= ia.P2N_MAX_HEADS,
             f'H={H} (at most {ia.P2N_MAX_HEADS} heads)')
    _require(Cz % 16 == 0 and 16 <= Cz <= SLOT,
             f'Cz={Cz} (a multiple of 16, at most {SLOT})')
    N, L, H = _check(named, reps, 'v4')
    lib = _library()
    with torch.cuda.device(qa.device):
        out = torch.empty_like(qa)
        p2n = torch.empty((N, L, H, Cz), dtype=qa.dtype, device=qa.device)
        err = lib.attention_v4(
            qa.data_ptr(), ka.data_ptr(), vvp.data_ptr(), bias.data_ptr(),
            z.data_ptr(), out.data_ptr(), p2n.data_ptr(), N, L, H, Cz, reps,
            _stream(qa))
    _raise_on(err, 'attention v4')
    launches['v4'] += 1
    return out, p2n
