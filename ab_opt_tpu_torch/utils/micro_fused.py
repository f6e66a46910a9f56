"""Time the fused-GABlock variants (S4) against K1, phase by phase.

Counterpart of ``scripts/micro_fused_variants.py``'s ``main`` (:195-260): at
the script's point (``reps`` replicas of one complex, L=128, F=128, H=12,
QK=V=32, P=PV=8, Cz=64, bf16; a seeded random GABlock through
``build_gablock_weights``, all rows valid) it prints ms per layer over
``ITERS`` chained layers (x fed forward), from CUDA events, of

* K1 (``gablock_layer``), the script's "v2 current";
* v3 (``gablock_layer_v3``, K1's launches with the attention over ``rt``
  replicas a block);
* the abl baseline (``gablock_layer_abl`` with no flag: K1's launches), each
  flag with a counterpart and the floor (see ``ops/gablock_variants.py`` for
  what each flag does to K1's launches);

each but the baseline with its saving against the abl baseline. Every
variant runs one warm-up layer before any is timed. Then ``ROUNDS`` rounds
each time every variant once, the order reversed every other round, so that
no variant is always first; a variant's time is the median of its rounds,
printed with their range. K1, v3 and the abl baseline run the same code, so
their gaps read the noise left. Beside each flag's saving it prints the
device time that ``torch.profiler`` gives one K1 layer's launches the flag
touches (attention, assemble, p2n, feat or the MLP GEMMs), so the ablation
and the direct measurement can be read against each other; then every
launch of that layer. Last, K1 against v3 at each ``rt`` of ``RTS`` that
divides ``reps``, in alternated rounds: whether K1's choice of ``rt``
(``attention_replicas``) is the fastest. It first prints the card's name
and power limit, and raises without a CUDA device: nothing runs on the CPU.
Run from the repository root on a machine with an NVIDIA GPU:

    python -m ab_opt_tpu_torch.utils.micro_fused [reps] [rt]
"""
from __future__ import annotations

import functools
import statistics
import subprocess
import sys

REPS, RT, LENGTH, ITERS, ROUNDS = 256, 4, 128, 30, 4
RTS = (1, 2, 4, 8)
# One K1 layer's launches in order: (label, a fragment of its kernel name).
K1_LAUNCHES = (('proj', 'k1_proj_kernel'), ('assemble', 'k1_assemble_kernel'),
               ('attention', 'k1_attn_kernel'), ('p2n', 'k1_p2n_kernel'),
               ('feat', 'k1_feat_kernel'), ('out+LN1', 'k1_gemm_kernel<1'),
               ('MLP1', 'k1_gemm_kernel<0'), ('MLP2', 'k1_gemm_kernel<0'),
               ('MLP3+LN2', 'k1_gemm_kernel<1'))
# The K1 launches each flag skips, fakes or replaces.
_MLP = ('MLP1', 'MLP2', 'MLP3+LN2')
TOUCHES = {'skip_p2n': ('p2n',), 'fake_softmax': ('attention',),
           'fake_alpha': ('attention',), 'skip_rot': ('assemble', 'feat'),
           'skip_mlp': _MLP, 'skip_sq': ('assemble',), 'fake_feat': ('feat',),
           'skip_values': ('attention',), 'thin_ops': ('assemble',),
           'floor': ('assemble', 'attention', 'p2n', 'feat') + _MLP}


def make_case(Nc, reps, L, device, n_pad=0, seed=0):
    """One seeded GABlock layer at the sampler's widths (H=12) in K1's form:
    the arguments of ``gablock_layer``."""
    from .bench_fixture import encoder_case
    args, bundles, biases = encoder_case(L, Nc, reps, 1, n_pad, device,
                                         seed=seed)
    _, _, R9, t, x, z, _, mask, _ = args
    return (x, R9, t, z, biases[0], mask, bundles[0], reps)


def chain_ms(layer, x, iters=ITERS):
    """ms per layer of ``layer`` chained ``iters`` times (each output the
    next input), from CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x = layer(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def variants(rt):
    """{name: layer(x, R9, t, z, bias, mask, wb, reps)} in the order the
    harness times them."""
    from ..ops import gablock as gb
    from ..ops import gablock_variants as gv
    out = {'K1': gb.gablock_layer,
           f'v3 rt={rt}': lambda *a: gv.gablock_layer_v3(*a, rt=rt),
           'abl baseline': gv.gablock_layer_abl}
    for flags in gv.ABLATIONS:
        name = 'abl floor' if flags == gv.FLOOR else f'abl {flags[0]}'
        out[name] = lambda *a, f=flags: gv.gablock_layer_abl(*a, flags=f)
    return out


def rt_layers(reps):
    """{name: layer} of K1 and v3 at each rt of :data:`RTS` that divides
    ``reps``."""
    from ..ops import gablock as gb
    from ..ops import gablock_variants as gv
    out = {'K1': gb.gablock_layer}
    for rt in RTS:
        if reps % rt == 0:
            out[f'v3 rt={rt}'] = functools.partial(gv.gablock_layer_v3, rt=rt)
    return out


def time_variants(args, layers, iters=ITERS, rounds=ROUNDS):
    """{name: [ms per layer, one a round]} of every entry of ``layers``
    (:func:`variants`, :func:`rt_layers`) on these CUDA arguments: one
    warm-up layer of each before any timing, then ``rounds`` rounds of
    ``iters`` chained layers of each, in the order of ``layers`` and
    reversed every other round (one warm-up and ``rounds * iters``
    launches each). Raises without CUDA inputs."""
    x, rest = args[0], args[1:]
    if not x.is_cuda:
        raise RuntimeError('micro_fused: the inputs must lie on a CUDA device')
    layers = {name: (lambda y, fn=fn: fn(y, *rest))
              for name, fn in layers.items()}
    for layer in layers.values():
        layer(x)
    names, ms = list(layers), {name: [] for name in layers}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            ms[name].append(chain_ms(layers[name], x, iters))
    return ms


def medians(ms):
    """{name: median ms per layer} of :func:`time_variants`' rounds."""
    return {name: statistics.median(t) for name, t in ms.items()}


def profile_layer(args):
    """[(kernel name, device us)] of each launch of one K1 layer under
    ``torch.profiler``, after a warm-up, in launch order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops import gablock as gb
    gb.gablock_layer(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gb.gablock_layer(*args)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, 'is_user_annotation', False)),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in events]


def by_kernel(rows):
    """[(kernel name, device us, launches)] of :func:`profile_layer`'s rows,
    summed by kernel, largest first."""
    sums = {}
    for name, us in rows:
        total, n = sums.get(name, (0.0, 0))
        sums[name] = (total + us, n + 1)
    return sorted(((k, us, n) for k, (us, n) in sums.items()),
                  key=lambda r: -r[1])


def launch_us(rows):
    """{label of :data:`K1_LAUNCHES`: device us} of :func:`profile_layer`'s
    rows, or None unless they are exactly K1's nine launches in order."""
    if len(rows) != len(K1_LAUNCHES) or not all(
            frag in name for (_, frag), (name, _) in zip(K1_LAUNCHES, rows)):
        return None
    return {label: us for (label, _), (_, us) in zip(K1_LAUNCHES, rows)}


def report(ms, rows):
    """Print the median times of :func:`time_variants`' rounds with their
    range, each variant's saving against the abl baseline beside the device
    time of the K1 launches its flag touches (from ``rows``, one K1 layer's
    :func:`profile_layer` at the same shape), and the profile."""
    med = medians(ms)
    base = med['abl baseline']
    per = launch_us(rows)
    for name, t in med.items():
        line = (f'{name + ":":24s}{t:9.4f} ms/layer (rounds '
                f'{min(ms[name]):.4f}-{max(ms[name]):.4f})')
        if name != 'abl baseline':
            line += f'  saves {base - t:8.4f} ms ({(base - t) / base:6.1%})'
        flag = name[4:] if name.startswith('abl ') else None
        if flag in TOUCHES:
            touched = TOUCHES[flag]
            us = (f'{sum(per[k] for k in touched):.1f} us' if per
                  else 'not measured')
            line += f'; its K1 launches ({", ".join(touched)}) {us}'
        print(line)
    total = sum(us for _, us in rows)
    print(f'one K1 layer under torch.profiler: {total:.1f} us of device '
          'time' + ('' if per else ' (not its nine launches: '
                    f'{len(rows)} kernels)'))
    for (label, _), (key, us) in zip(K1_LAUNCHES, rows) if per else ():
        print(f'  {us:9.1f} us {us / total:6.1%}  {label:9s} {key[:80]}')
    for key, us, n in () if per else by_kernel(rows):
        print(f'  {us:9.1f} us {us / total:6.1%} x{n}  {key[:90]}')


def report_rts(ms):
    """Print the medians of K1 and v3 at each rt (:func:`rt_layers`), each
    with its ratio to K1's."""
    med = medians(ms)
    print('K1 against v3 at each rt (medians of alternated rounds):')
    for name, t in med.items():
        print(f'  {name + ":":10s}{t:9.4f} ms/layer (rounds '
              f'{min(ms[name]):.4f}-{max(ms[name]):.4f}), '
              f'{t / med["K1"]:.3f}x K1')


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('micro_fused: needs a CUDA device')
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else REPS
    rt = int(sys.argv[2]) if len(sys.argv) > 2 else RT
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    torch.set_grad_enabled(False)
    args = make_case(1, reps, LENGTH, torch.device('cuda'))
    print(f'Nc=1, reps={reps}, rt={rt}, L={LENGTH}, F=128, H=12, Cz=64, '
          f'bf16, median of {ROUNDS} rounds of {ITERS} chained layers')
    report(time_variants(args, variants(rt)), profile_layer(args))
    report_rts(time_variants(args, rt_layers(reps)))


if __name__ == '__main__':
    main()
