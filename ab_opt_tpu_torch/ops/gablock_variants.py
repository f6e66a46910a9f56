"""The fused-GABlock variant harness (S4): K1 with its attention batched over
a chosen number of replicas (v3), and K1 with one phase skipped or faked
(abl), their wrappers and their plain versions.

Counterpart of ``scripts/micro_fused_variants.py``: the two bodies its
``run_layer`` (:165) launches, ``_gablock_kernel_v3`` (:48) and
``_gablock_kernel_abl`` (:264). Both run K1's own launches and tiles
(``csrc/gablock.cu``, ``forward_k1<mask>`` through its entry
``gablock_forward_variant``); no route of the sampler selects them. They
exist to be timed against K1 (``utils/micro_fused.py``): the ablations
price the phases of K1's launches as they are.

* v3 (:func:`gablock_layer_v3`): K1 itself (mask 0) with the attention
  run by one block per (query tile, head, ``rt`` replicas of one complex),
  the tile's pair-bias rows staged once for all ``rt`` replicas; K1 takes
  ``rt`` = :func:`.gablock.attention_replicas`. Grouping replicas changes no
  sum, so v3 equals K1 bit for bit at every ``rt``. Its plain version is
  K1's, :func:`.gablock.gablock_layer_reference`.
* abl (:func:`gablock_layer_abl`): K1 (with K1's ``rt``) with the phases
  ``flags`` names skipped or faked; with no flag it is K1. Plain version
  :func:`gablock_layer_abl_reference`.

How each of the script's flags (``FLAGS``) maps onto K1:

==============  ==========================================================
flag            counterpart
==============  ==========================================================
skip_p2n        K1's p2n launch skipped; the p2n feature columns zero
fake_softmax    attention tile: alpha = bf16(0.01 (logits + bias)), no
                max/exp/sum
fake_alpha      attention tile: alpha = bf16(0.01 bias), no logits product
                (K's and Q's rows not loaded), no softmax
skip_rot        assemble without R, t; feat without R^T (. - t)
skip_mlp        the MLP GEMMs and LN2 not launched; out = x1
skip_sq         assemble: the |p|^2 slot takes the first H planar point
                columns (x of the operand's first H points)
fake_feat       K1's feat launch replaced by a copy: the H (V + 7 PV)
                non-p2n feature columns are ``[o | o[:, :H (V + 7 PV) -
                H 64]]`` over o's 64-wide slots (pad zero)
skip_values     attention tile: no alpha . V; o = the replica's own vvp rows
thin_ops        assemble: the point and |p|^2 slots of qa/ka and the point
                slots of vvp zero, the constant slots kept
skip_sect       none (see below)
skip_out        none (see below)
skip_wpts       none (see below)
==============  ==========================================================

Three flags have no counterpart and select no phase: ``skip_sect`` drops
the 3-way concat that re-gathers each operand's point sections from a
component-major point projection, and K1's projection is operand-major
already, so there is no gather to drop; ``skip_out`` and ``skip_wpts`` are
in the script body's signature, which never reads them. A flag set made
only of these is the baseline. The floor (``FLOOR``) is the script's
floor (:243-246) less ``skip_sect``.

The kernel takes the flag sets the harness uses: none, each single flag
with a counterpart, and the floor; the wrapper refuses any other set. The
plain version takes any set.

Both wrappers take K1's bundle and operands (:func:`.gablock.gablock_layer`)
and refuse a tensor that requires a gradient (no backward). A CPU ``x``
takes the plain version; any other device launches the kernel or raises.
Nothing falls back. ``launches['v3']`` and ``launches['abl']`` count the
launches.
"""
from __future__ import annotations

import torch

from . import gablock as gb

FLAGS = ('skip_p2n', 'fake_softmax', 'fake_alpha', 'skip_rot', 'skip_mlp',
         'skip_out', 'skip_sect', 'skip_sq', 'fake_feat', 'skip_values',
         'skip_wpts', 'thin_ops')
# The kernel's mask bit of each flag with a counterpart (the ABL_* enum of
# csrc/k1_tiles.cuh, in this order).
ABL_BITS = {name: 1 << i for i, name in enumerate((
    'skip_p2n', 'fake_softmax', 'fake_alpha', 'skip_rot', 'skip_mlp',
    'skip_sq', 'fake_feat', 'skip_values', 'thin_ops'))}
NO_COUNTERPART = ('skip_sect', 'skip_out', 'skip_wpts')
FLOOR = ('skip_sq', 'skip_values', 'fake_feat', 'fake_alpha', 'skip_rot',
         'skip_p2n', 'skip_mlp')
# The flag sets the harness runs beside the baseline: each flag with a
# counterpart, then the floor. With the baseline they are the kernel's masks.
ABLATIONS = tuple((f,) for f in ABL_BITS) + (FLOOR,)
KERNEL_MASKS = frozenset(
    [0] + [sum(ABL_BITS[f] for f in flags) for flags in ABLATIONS])

launches = {'v3': 0, 'abl': 0}


def reset_counts():
    """Zero the variants' launch counts and their plain versions' call
    counts (v3's is K1's, see :func:`.gablock.reset_counts`)."""
    for k in launches:
        launches[k] = 0
    gablock_layer_abl_reference.calls = 0
    gb.gablock_layer_reference.calls = 0


# ------------------------------------------------------------ plain version


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f'gablock_variants: {msg}')


def _no_grad(named):
    for name, a in named.items():
        _require(not a.requires_grad,
                 f'{name} requires a gradient: the variants have no backward')


def _ablations(flags) -> frozenset:
    flags = frozenset(flags)
    unknown = sorted(flags - set(FLAGS))
    _require(not unknown, f'unknown flags {unknown} (the script has {FLAGS})')
    return flags - set(NO_COUNTERPART)


def abl_mask(flags) -> int:
    """The kernel's mask for ``flags``; raises on a name the script does not
    have or a set the kernel does not take."""
    mask = sum(ABL_BITS[f] for f in _ablations(flags))
    _require(mask in KERNEL_MASKS,
             f'flags {sorted(flags)}: the kernel takes none, one flag with a '
             'counterpart, or the floor')
    return mask


def gablock_layer_abl_reference(x, R9, t, z, bias, mask, wb, reps: int = 1,
                                flags=()):
    """K1's plain version (:func:`.gablock.gablock_layer_reference`) with the
    phases ``flags`` names skipped or faked, as the table in the module
    docstring says; any set of :data:`FLAGS`."""
    gablock_layer_abl_reference.calls += 1
    return gb._layer_math(x, R9, t, z, bias, mask, wb, reps, None,
                          _ablations(flags))


gablock_layer_abl_reference.calls = 0


# ------------------------------------------------------------ the kernels


def _prepare(x, R9, t, z, bias, mask, wb, reps, rt):
    """Refuse gradients and an ``rt`` that does not divide ``reps``; True
    where the inputs go to the card (then after K1's operand checks)."""
    _no_grad({'x': x, 'R9': R9, 't': t, 'z': z, 'bias': bias, 'mask': mask})
    _require(reps % rt == 0, f'rt={rt} must divide reps={reps}')
    if x.device.type == 'cpu':
        return False
    gb._check_inputs(x, R9, t, z, bias, mask, wb, reps,
                     who='gablock_variants')
    return True


def gablock_layer_v3(x, R9, t, z, bias, mask, wb, reps: int, rt: int):
    """v3: one GABlock layer through K1's launches with the attention
    batched over ``rt`` replicas of one complex (``rt`` >= 1 divides
    ``reps``). Operands as :func:`.gablock.gablock_layer`."""
    _require(rt >= 1, f'rt={rt} (v3 batches at least one replica)')
    if not _prepare(x, R9, t, z, bias, mask, wb, reps, rt):
        return gb.gablock_layer_reference(x, R9, t, z, bias, mask, wb, reps)
    out = gb._launch_layer('gablock_forward_variant', x, R9, t, z, bias, mask,
                           wb, reps, 0, rt)
    launches['v3'] += 1
    return out


def gablock_layer_abl(x, R9, t, z, bias, mask, wb, reps: int = 1, flags=()):
    """abl: one GABlock layer through K1 with the phases ``flags`` names
    skipped or faked (none, one flag, or the floor; see the module
    docstring). Operands as :func:`.gablock.gablock_layer`."""
    abl = abl_mask(flags)
    rt = gb.attention_replicas(reps)
    if not _prepare(x, R9, t, z, bias, mask, wb, reps, rt):
        return gablock_layer_abl_reference(x, R9, t, z, bias, mask, wb, reps,
                                           flags)
    out = gb._launch_layer('gablock_forward_variant', x, R9, t, z, bias, mask,
                           wb, reps, abl, rt)
    launches['abl'] += 1
    return out
