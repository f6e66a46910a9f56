"""Where the chained whole-encoder kernel's (K5's) time goes on the card.

Builds ``csrc/gablock_chain.cu`` with its phase marks on
(``-DGABLOCK_CHAIN_PROFILE``: block 0's thread 0 adds up clock64 cycles
between the barriers that close each phase of a layer) and runs it on the
sampler's shapes (L=128, H=12, six layers with distinct seeded weights,
bf16) at reps 256 and 32. For each it prints the encoder pass's time (CUDA
events, the regular build), block 0's cycles per trajectory and their share
by phase: projection (x -> qa/ka/vvp for every row), stage (a head's K, V
and bias rows into shared memory), logits, softmax, values (alpha . V),
features (the head's node and point features), p2n (alpha . z) and tail
(out_transform, LayerNorms, MLP).

Run from the repository root on a machine with an NVIDIA GPU:

    python -m ab_opt_tpu_torch.utils.profile_chain
"""
from __future__ import annotations

import ctypes
import subprocess

PHASES = ('projection', 'stage', 'logits', 'softmax', 'values', 'features',
          'p2n', 'tail')
LENGTH, HEADS, LAYERS, CALLS = 128, 12, 6, 5


def main():
    import torch
    from ..ops import gablock
    from .bench_fixture import encoder_case

    if not torch.cuda.is_available():
        raise SystemExit('profile_chain: needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    torch.set_grad_enabled(False)
    device = torch.device('cuda')
    lib = gablock._chain_library(gablock.CHAIN_PROFILE_FLAGS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    for reps in (256, 32):
        args = encoder_case(LENGTH, 1, reps, LAYERS, 0, device, H=HEADS)[0]
        run = lambda: gablock.fused_encoder_chained(*args)
        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / CALLS
        gablock._launch_chain(lib, *args)         # warm-up of the profile build
        torch.cuda.synchronize()
        lib.gablock_chain_phase_cycles(cycles, 1)
        for _ in range(CALLS):
            gablock._launch_chain(lib, *args)
        torch.cuda.synchronize()
        lib.gablock_chain_phase_cycles(cycles, 1)
        # Block 0 runs trajectories 0, grid, 2 grid, ... of each call; at
        # L=128 a block takes the SM (one block an SM), so grid = min(N, SMs).
        trajs = CALLS * -(-reps // min(reps, sms))
        total = sum(cycles)
        print(f'reps {reps} (N={reps}, L={LENGTH}, H={HEADS}, {LAYERS} '
              f'layers, bf16): {ms:.4f} ms per encoder pass; block 0: '
              f'{total / trajs:.0f} cycles per trajectory')
        for name, c in zip(PHASES, cycles):
            print(f'  {name:10s} {c / trajs:12.0f} cycles  {c / total:6.1%}')


if __name__ == '__main__':
    main()
