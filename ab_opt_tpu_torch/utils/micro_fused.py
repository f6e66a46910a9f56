"""Time the fused-GABlock variants (S4) against K1, phase by phase.

Counterpart of ``scripts/micro_fused_variants.py``'s ``main`` (:195-260): at
the script's point (``reps`` replicas of one complex, L=128, F=128, H=12,
QK=V=32, P=PV=8, Cz=64, bf16; a seeded random GABlock through
``build_gablock_weights``, all rows valid) it prints ms per layer over
``ITERS`` chained layers (x fed forward), from CUDA events, of

* K1 (``gablock_layer``), the script's "v2 current";
* v3 (``gablock_layer_v3``, the attention over ``rt`` replicas);
* the abl baseline (``gablock_layer_abl`` with no flag), each flag with a
  counterpart and the floor (see ``ops/gablock_variants.py`` for what each
  flag does here);

each but the baseline with its saving against the abl baseline. Every
variant runs one warm-up layer before any is timed. Then ``ROUNDS`` rounds
each time every variant once, the order reversed every other round, so that
no variant is always first; a variant's time is the median of its rounds,
printed with their range. K1 and the abl baseline run the same code, so
their gap reads the noise left. Then, as a direct measurement beside the
ablations, it prints the device time of each launch of one K1 layer from
``torch.profiler``. It first prints the
card's name and power limit, and raises without a CUDA device: nothing
runs on the CPU. Run from the repository root on a machine with an NVIDIA
GPU:

    python -m ab_opt_tpu_torch.utils.micro_fused [reps] [rt]
"""
from __future__ import annotations

import statistics
import subprocess
import sys

REPS, RT, LENGTH, ITERS, ROUNDS = 256, 4, 128, 30, 4


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


def time_variants(args, rt, iters=ITERS, rounds=ROUNDS):
    """{name: [ms per layer, one a round]} of every entry of
    :func:`variants` on these CUDA arguments: one warm-up layer of each
    before any timing, then ``rounds`` rounds of ``iters`` chained layers of
    each, in the order of :func:`variants` and reversed every other round
    (one warm-up and ``rounds * iters`` launches each). Raises without CUDA
    inputs."""
    x, rest = args[0], args[1:]
    if not x.is_cuda:
        raise RuntimeError('micro_fused: the inputs must lie on a CUDA device')
    layers = {name: (lambda y, fn=fn: fn(y, *rest))
              for name, fn in variants(rt).items()}
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
    """[(kernel name, device us, launches)] of one K1 layer under
    ``torch.profiler``, after a warm-up, largest first."""
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
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]
    return sorted(rows, key=lambda r: -r[1])


def report(ms, rows):
    """Print the median times of :func:`time_variants`' rounds with their
    range, each variant's saving against the abl baseline, and the
    profile."""
    med = medians(ms)
    base = med['abl baseline']
    for name, t in med.items():
        saving = (f'  saves {base - t:8.4f} ms ({(base - t) / base:6.1%})'
                  if name != 'abl baseline' else '')
        print(f'{name + ":":24s}{t:9.4f} ms/layer (rounds {min(ms[name]):.4f}'
              f'-{max(ms[name]):.4f}){saving}')
    total = sum(r[1] for r in rows)
    print(f'one K1 layer under torch.profiler: {total:.1f} us of device '
             'time')
    for key, us, n in rows:
        print(f'  {us:9.1f} us {us / total:6.1%} x{n}  {key[:90]}')


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
    report(time_variants(args, rt), profile_layer(args))


if __name__ == '__main__':
    main()
