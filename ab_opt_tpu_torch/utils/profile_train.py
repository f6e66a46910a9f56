"""Where a DiffAb training step's time goes on the card.

The step is the training slice of ``chip_smoke.py`` (bf16, 6 layers, batch
16 of the synthetic complex at L=128, Adam, clip 100) through
:meth:`ab_opt_tpu_torch.train.Trainer.train_step`. After 3 warm-up steps it
times 5 steps without the profiler, then 5 more under ``torch.profiler``,
and prints: wall ms per step, device busy ms per step (the sum of kernel,
copy and set times), the device's idle share, the time in the K2/K3
kernels, the peak device memory, and the 15 kernels with the most device
time.

Run from the repository root on a machine with an NVIDIA GPU:

    python -m ab_opt_tpu_torch.utils.profile_train

``--k3-launches`` prints instead, as one JSON line, the device kernels of
one K3 call (``ipa_attention_bwd``) at the step's shape (bf16, N=16,
L=128, H=12: the tile route) under ``torch.profiler``, after a warm-up
call: ``[[name, count], ...]``. A profiler session after another in one
process records no device events, so callers run it in a process of its
own.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# K2's and K3's kernels on either route: the tiles (bf16 up to L=256, the
# training path) and the CUDA-core kernels (float32, bf16 past L=256).
K23_NAMES = ('k2_tile_kernel', 'k3_tile_kernel', 'fwd_kernel',
             'bwd_rows_kernel', 'bwd_cols_kernel')
BATCH, LENGTH, HEADS = 16, 128, 12
WARMUP, STEPS, TOP = 3, 5, 15


def device_kernels(prof):
    """Device-side work only: kernels, copies and sets, not the ranges the
    profiler draws on the device timeline for annotated regions."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]


def k3_launches():
    """The device kernels of one K3 call at the step's shape: [(name,
    count), ...]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import ipa_attention as ia
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    HD = HEADS * 64
    qa, ka, vvp, dout = (r(BATCH, LENGTH, HD) for _ in range(4))
    bias = r(BATCH, HEADS, LENGTH, LENGTH)
    dalphas = r(BATCH, HEADS, LENGTH, LENGTH)
    with torch.no_grad():
        alphas = ia.ipa_attention_fwd(qa, ka, vvp, bias)[1]
        call = lambda: ia.ipa_attention_bwd(qa, ka, vvp, alphas, dout, dalphas)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    return [(e.key, e.count) for e in device_kernels(prof)]


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models import DiffAb, DiffAbConfig
    from ..train import DIFFAB_TRAIN_CONFIG, Trainer
    from .bench_fixture import synthetic_batch

    if not torch.cuda.is_available():
        raise SystemExit('profile_train: needs a CUDA device')
    if '--k3-launches' in sys.argv[1:]:
        print(json.dumps(k3_launches()))
        return
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(2)
    trainer = Trainer(DiffAb(DiffAbConfig(dtype='bfloat16')),
                      DIFFAB_TRAIN_CONFIG)
    batch = synthetic_batch(np.random.default_rng(1), N=BATCH, L=LENGTH,
                            n_ab=int(LENGTH * 0.7), gen_lo=LENGTH // 4,
                            gen_hi=LENGTH // 4 + 8, device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(4)

    def run():
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    for _ in range(WARMUP):
        trainer.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = run()
    kernels = device_kernels(prof)
    per_step = lambda e: e.self_device_time_total / 1e3 / STEPS   # ms
    busy = sum(map(per_step, kernels))
    k23 = sum(per_step(e) for e in kernels
              if any(n in e.key for n in K23_NAMES))
    print(f'batch {BATCH}, L={LENGTH}, bf16, '
          f'{trainer.model.cfg.num_layers} layers, {STEPS} steps after '
          f'{WARMUP} warm-up steps')
    print(f'wall ms/step {wall:.3f} ({BATCH / wall * 1e3:.3f} samples/s); '
          f'under the profiler {wall_prof:.3f}')
    print(f'device busy ms/step {busy:.3f}; idle share of the profiled '
          f'wall time {1.0 - busy / wall_prof:.3f}')
    print(f'K2/K3 kernels ms/step {k23:.3f} ({k23 / busy:.3%} of busy)')
    print(f'kernel launches/step {sum(e.count for e in kernels) / STEPS:.1f}')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}'
          ' GiB')
    print('top kernels by device time (ms/step, launches/step, share):')
    for e in sorted(kernels, key=per_step, reverse=True)[:TOP]:
        print(f'  {per_step(e):8.3f} {e.count / STEPS:6.1f} '
              f'{per_step(e) / busy:7.2%}  {e.key[:100]}')


if __name__ == '__main__':
    main()
