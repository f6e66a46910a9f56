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

S1 runs K1's replica-group attention tile (``csrc/k1_tiles.cuh``, the tile
of K1's attention launch, :func:`.gablock.gablock_attention`) with alpha in
K2's (N, H, L, L) layout (v1) or not stored at all (v3), in blocks of
:func:`.gablock.attention_replicas` replicas.

Every wrapper refuses an input that requires a gradient (the variants have
no backward), takes the plain version for a CPU ``qa``, and on any other
device launches its kernel or raises; nothing falls back. The card kernels
take bfloat16 only (the script runs them only in bf16), L a multiple of 16
up to the cap that their shared-memory plan allows (:func:`max_length`: 256
for S1, as K1 takes it; 128 for S3 and 192 for S2 at 12 heads).
``launches[name]`` counts the kernel launches of ``'v1'``, ``'v3'``,
``'v2'`` and ``'v4'``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from . import ipa_attention as ia
from .gablock import attention_replicas

SLOT = ia.SLOT
TILE = 16                  # query rows a block
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


# ------------------------------------------------------ shared-memory plans
# The same arithmetic as attention_tile_smem(), phased_smem() and
# head_batched_smem() in the source; a card test and chip_smoke.py phase 11
# hold the two against each other.

TILE_MAX_L = 256           # S1: K1's attention tile takes L up to 256


def tile_smem(L: int) -> int:
    """Bytes of shared memory a block of S1 takes: K1's attention tile, the
    bias rows of its query tile and its K / V / Q stages (whatever H)."""
    return ia._attn_plan(L)[3]


def _s_ld(L):
    return max(L, SLOT) + 4


def phased_smem(L: int, H: int) -> int:
    """Bytes of shared memory a block of S3 takes: the query rows, two
    heads' K or V, every head's f32 logits and the bf16 alphas."""
    s_floats = max(H * TILE * _s_ld(L), 2048)
    a_rows = (TILE - 1) * H + max(H, 16)
    return (TILE * (H * SLOT + 8) * 2 + 2 * L * (SLOT + 8) * 2
            + s_floats * 4 + a_rows * (L + 16) * 2)


def head_batched_smem(L: int, H: int) -> int:
    """Bytes of shared memory a block of S2 takes: one warp a head (at most
    16), each with its head's f32 logits and bf16 alphas."""
    return min(H, 16) * (TILE * _s_ld(L) * 4 + TILE * (L + 16) * 2)


def max_length(kind: str, H: int) -> int:
    """The largest L (a multiple of 16) that the kind's block takes:
    ``kind`` 'tile' (S1: K1's limit), 'phased' (S3) or 'head_batched' (S2:
    the largest whose block fits in shared memory); 0 if none does."""
    if kind == 'tile':
        return TILE_MAX_L
    smem = phased_smem if kind == 'phased' else head_batched_smem
    return next((L for L in range(ia.MAX_L, 0, -TILE)
                 if smem(L, H) <= SMEM_BLOCK), 0)


# ------------------------------------------------------------ the kernels


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(
        build.build_sources([_SRC], build.BUILD_DIR)[str(_SRC)]['path'])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.attention_tile.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.attention_tile.restype = I
    lib.attention_phased.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.attention_phased.restype = I
    lib.attention_tile_smem.argtypes = [I]
    lib.attention_tile_smem.restype = ctypes.c_size_t
    lib.attention_head_batched.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.attention_head_batched.restype = I
    for fn in (lib.attention_phased_smem, lib.attention_head_batched_smem):
        fn.argtypes = [I, I]
        fn.restype = ctypes.c_size_t
    lib.attention_variants_error_string.argtypes = [I]
    lib.attention_variants_error_string.restype = ctypes.c_char_p
    return lib


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
    the kind's cap, then K2's shape, contiguity and device checks."""
    qa = named['qa']
    _require(qa.dtype == torch.bfloat16,
             f'dtype {qa.dtype}: the card kernels take bfloat16 only')
    if qa.dim() == 3 and qa.shape[-1] % SLOT == 0 and qa.shape[-1] > 0:
        L, H = qa.shape[1], qa.shape[-1] // SLOT
        cap = max_length(kind, H)
        _require(L <= cap, f'L={L} is past the cap L={cap} of the {kind} '
                           f'kernel at H={H} (its shared-memory plan)')
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
    """S2: (out, alphas), K2's function with one warp a head and no
    block-wide barrier; K and V fragments straight from global memory."""
    named = {'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias}
    _no_grad(named)
    if qa.device.type == 'cpu':
        return ia.ipa_attention_fwd_reference(qa, ka, vvp, bias, reps)
    N, L, H = _check(named, reps, 'head_batched')
    lib = _library()
    with torch.cuda.device(qa.device):
        out = torch.empty_like(qa)
        alphas = torch.empty((N, H, L, L), dtype=qa.dtype, device=qa.device)
        err = lib.attention_head_batched(
            qa.data_ptr(), ka.data_ptr(), vvp.data_ptr(), bias.data_ptr(),
            out.data_ptr(), alphas.data_ptr(), N, L, H, reps, _stream(qa))
    _raise_on(err, 'attention v2')
    launches['v2'] += 1
    return out, alphas


def attention_v4(qa, ka, vvp, bias, z, reps: int = 1):
    """S3: (out, p2n), K4's function, phase-separated in one block of 16
    query rows: every head's logits, one softmax pass, every head's alpha .
    vvp, then p2n[n, i, h] = sum_j alpha[n, h, i, j] z[n // reps, i, j] from
    the alphas in shared memory."""
    named = {'qa': qa, 'ka': ka, 'vvp': vvp, 'bias': bias, 'z': z}
    _no_grad(named)
    if qa.device.type == 'cpu':
        return ia.ipa_attention_fwd_p2n_reference(qa, ka, vvp, bias, z, reps)
    H, Cz = qa.shape[-1] // SLOT, z.shape[-1]
    # One 16 x 16 tile holds every head of a query.
    _require(H <= ia.P2N_MAX_HEADS,
             f'H={H} (at most {ia.P2N_MAX_HEADS} heads)')
    _require(Cz % 16 == 0 and 16 <= Cz <= SLOT,
             f'Cz={Cz} (a multiple of 16, at most {SLOT})')
    N, L, H = _check(named, reps, 'phased')
    lib = _library()
    with torch.cuda.device(qa.device):
        out = torch.empty_like(qa)
        p2n = torch.empty((N, L, H, Cz), dtype=qa.dtype, device=qa.device)
        err = lib.attention_phased(
            qa.data_ptr(), ka.data_ptr(), vvp.data_ptr(), bias.data_ptr(),
            z.data_ptr(), out.data_ptr(), p2n.data_ptr(), N, L, H, Cz, reps,
            _stream(qa))
    _raise_on(err, 'attention v4')
    launches['v4'] += 1
    return out, p2n
