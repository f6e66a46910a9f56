"""Where the chained whole-encoder kernel's (K5's) time goes on the card.

Builds ``csrc/gablock_chain.cu`` with its marks on
(``-DGABLOCK_CHAIN_PROFILE``: each block's thread 0 adds the %globaltimer
nanoseconds of every work item to its kind, the time from claiming an item
to its dependencies being met to the waits, and its whole run) and runs it
on the sampler's shapes (L=128, H=12, six layers with distinct seeded
weights, bf16) at reps 256 and 32. For each it prints the encoder pass's
time and that of six K1 layers on the same inputs (CUDA events, the regular
builds, the median of ``ROUNDS`` rounds, the order alternated), then, per
item kind (proj, assemble, attention, feat, p2n, tail), for the waits, for
the rest of the blocks' runs (claims) and for the pass's time outside them
(the launch, blocks starting late or done early), the mean over the grid's
blocks in ms a pass and its share; beside each kind, the device time of
K1's launches of the same phase (``torch.profiler``, one layer, times six):
proj ``k1_proj_kernel``, assemble ``k1_assemble_kernel``, attention
``k1_attn_kernel``, feat ``k1_feat_kernel``, p2n ``k1_p2n_kernel``, tail the
four ``k1_gemm_kernel`` launches. Under tail, its four GEMM tiles
(out_transform + LN1, MLP1, MLP2, MLP3 + LN2); under p2n, its waits for the
next row's copies.

With ``--launches`` it prints instead, as one JSON list, the device kernels
of one encoder pass at reps 256 under ``torch.profiler`` ([name, count]
pairs, after a warm-up pass): in a process of its own, since a profiler
session that follows another in one process may record no device events.

Run from the repository root on a machine with an NVIDIA GPU:

    python -m ab_opt_tpu_torch.utils.profile_chain [--launches]
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

LENGTH, HEADS, LAYERS, CALLS, ROUNDS = 128, 12, 6, 5, 4
K1_LAUNCHES = {'proj': ('k1_proj_kernel',),
               'assemble': ('k1_assemble_kernel',),
               'attention': ('k1_attn_kernel',), 'feat': ('k1_feat_kernel',),
               'p2n': ('k1_p2n_kernel',), 'tail': ('k1_gemm_kernel',)}


def _smi(query):
    return subprocess.run(['nvidia-smi', f'--query-gpu={query}',
                           '--format=csv,noheader,nounits'],
                          capture_output=True, text=True).stdout.strip()


def time_pass(run, calls=CALLS):
    """ms per call of ``run`` over ``calls`` calls, from CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def k5_and_six_k1(args, bundles, biases, rounds=ROUNDS, calls=CALLS):
    """{'K5': [ms...], 'six K1': [ms...]}: ``rounds`` rounds of ``calls``
    encoder passes each, both warmed first, the order alternated."""
    from ..ops import gablock
    _, _, R9, t, x, z, _, mask, reps = args

    def six_k1():
        y = x
        for wb, bias in zip(bundles, biases):
            y = gablock.gablock_layer(y, R9, t, z, bias, mask, wb, reps)
        return y

    runs = {'K5': lambda: gablock.fused_encoder_chained(*args),
            'six K1': six_k1}
    for run in runs.values():
        run()
    ms = {name: [] for name in runs}
    for r in range(rounds):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            ms[name].append(time_pass(runs[name], calls))
    return ms


def kind_ms(args, grid, calls=CALLS):
    """ms a pass of the mean block by item kind, then the waits, the rest
    of the blocks' runs and the tail's four GEMMs, from the profiling build:
    ``len(CHAIN_KINDS) + 7`` values (the last: p2n's waits for its
    copies)."""
    import torch
    from ..ops import gablock
    lib = gablock._chain_library(gablock.CHAIN_PROFILE_FLAGS)
    ns = (ctypes.c_ulonglong * (len(gablock.CHAIN_KINDS) + 7))()
    gablock._launch_chain(lib, *args)         # builds the plan, warms up
    torch.cuda.synchronize()
    lib.gablock_chain_profile_ns(ns, 1)
    for _ in range(calls):
        gablock._launch_chain(lib, *args)
    torch.cuda.synchronize()
    lib.gablock_chain_profile_ns(ns, 1)
    per_block = [v / calls / grid / 1e6 for v in ns]
    n = len(gablock.CHAIN_KINDS) + 1
    per_block[n] -= sum(per_block[:n])
    marks = per_block[n + 1:n + 5]   # the tail's GEMMs, cumulative
    return (per_block[:n + 1] + [b - a for a, b in zip([0.0] + marks, marks)]
            + per_block[n + 5:])


def k1_by_kind(args, bundles, biases):
    """us of device time K1's launches of each kind take in six layers (one
    layer under torch.profiler, times six)."""
    from .micro_fused import profile_layer
    _, _, R9, t, x, z, _, mask, reps = args
    rows = profile_layer((x, R9, t, z, biases[0], mask, bundles[0], reps))
    return {kind: LAYERS * sum(us for key, us, _ in rows
                               if any(k in key for k in names))
            for kind, names in K1_LAUNCHES.items()}


def pass_launches(args):
    """[[kernel name, count]] of the device kernels of one K5 pass on
    ``args`` under torch.profiler, after a warm-up pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ..ops import gablock
    gablock.fused_encoder_chained(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gablock.fused_encoder_chained(*args)
        torch.cuda.synchronize()
    return [[e.key, e.count] for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]


def main(argv=()):
    import torch
    from ..ops import gablock
    from .bench_fixture import encoder_case

    if not torch.cuda.is_available():
        raise SystemExit('profile_chain: needs a CUDA device')
    torch.set_grad_enabled(False)
    device = torch.device('cuda')
    if '--launches' in argv:
        args = encoder_case(LENGTH, 1, 256, LAYERS, 0, device, H=HEADS)[0]
        print(json.dumps(pass_launches(args)))
        return
    print(_smi('name,power.limit'))
    shape = gablock.chain_launch_shape(LENGTH, HEADS)
    names = gablock.CHAIN_KINDS + ('waits', 'other', ' tail: out',
                                   ' tail: MLP1', ' tail: MLP2', ' tail: MLP3',
                                   ' p2n: copies')
    for reps in (256, 32):
        args, bundles, biases = encoder_case(LENGTH, 1, reps, LAYERS, 0,
                                             device, H=HEADS)
        ms = k5_and_six_k1(args, bundles, biases)
        med = {n: statistics.median(v) for n, v in ms.items()}
        per_block = kind_ms(args, shape['grid'])
        k1 = k1_by_kind(args, bundles, biases)
        print(f'reps {reps} (N={reps}, L={LENGTH}, H={HEADS}, {LAYERS} '
              f'layers, bf16): K5 {med["K5"]:.4f} ms a pass, six K1 '
              f'{med["six K1"]:.4f} (medians of {ROUNDS} alternated rounds; '
              + ', '.join(f'{n} {min(v):.4f}-{max(v):.4f}'
                          for n, v in ms.items())
              + f'), K5 / six K1 {med["K5"] / med["six K1"]:.3f}; grid '
              f'{shape["grid"]} x {shape["threads"]} threads, '
              f'{shape["smem_bytes"]} bytes a block')
        outside = med['K5'] - sum(per_block[:len(gablock.CHAIN_KINDS) + 2])
        print(f'  {"kind":12s} {"ms a block":>10s} {"share":>7s}  K1 launches '
              '(six layers)')
        for name, v in zip(names, per_block):
            k1_ms = f'{k1[name] / 1e3:8.4f} ms' if name in k1 else ''
            print(f'  {name:12s} {v:10.4f} {v / med["K5"]:7.1%}  {k1_ms}')
        print(f'  {"outside":12s} {outside:10.4f} {outside / med["K5"]:7.1%}'
              '  (the pass less the mean block\'s run)')


if __name__ == '__main__':
    main(sys.argv[1:])
