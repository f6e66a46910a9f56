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
"""
from __future__ import annotations

import subprocess
import time

K23_NAMES = ('fwd_kernel', 'bwd_rows_kernel', 'bwd_cols_kernel')
BATCH, LENGTH = 16, 128
WARMUP, STEPS, TOP = 3, 5, 15


def main():
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..models import DiffAb, DiffAbConfig
    from ..train import DIFFAB_TRAIN_CONFIG, Trainer
    from .bench_fixture import synthetic_batch

    if not torch.cuda.is_available():
        raise SystemExit('profile_train: needs a CUDA device')
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
    # Device-side work only: kernels, copies and sets, not the ranges the
    # profiler draws on the device timeline for annotated regions.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
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
