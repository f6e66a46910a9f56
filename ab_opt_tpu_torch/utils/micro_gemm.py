"""Device time of K1's GEMM tile alone (``ops.gablock.gablock_gemm``: the
``k1_gemm_kernel`` launch that K1's four N=128 products and K5's tail run)
at M = 128, 256, 4096 and 32768 rows and K = 128 and 1824 (the MLP and the
out_transform at H=12), with the LayerNorm and the bf16 (bias, ReLU)
epilogues, bf16 operands from a seed.

Each time is the mean of ``ITERS`` launches between two CUDA events, with
the device kept busy (``torch.cuda._sleep``) while the host enqueues them,
so the host's per-call cost does not enter it. The difference between the
two K at one M is the K loop's cost (27 chunks of 64); the difference
between the two epilogues at one M and K is the LayerNorm's.

Run from the repository root on a machine with an NVIDIA GPU:

    python -m ab_opt_tpu_torch.utils.micro_gemm
"""
from __future__ import annotations

import subprocess

ROWS = (128, 256, 4096, 32768)
DEPTHS = (128, 1824)
ITERS = 20


def device_ms(fn, iters=ITERS):
    """ms a call of ``fn`` on the device: the first call warms up, then
    ``iters`` calls are enqueued behind a device-side sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch
    from ..ops import gablock as gb

    if not torch.cuda.is_available():
        raise SystemExit('micro_gemm: needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device='cuda').manual_seed(0)
    r = lambda *s: torch.randn(*s, device='cuda', generator=g)
    bf16 = torch.bfloat16
    for M in ROWS:
        for K in DEPTHS:
            a, w = r(M, K).to(bf16), r(128, K).to(bf16)
            bias, resid, ln = r(128), r(M, 128), r(2, 128)
            t_ln = device_ms(lambda: gb.gablock_gemm(a, w, bias, resid=resid,
                                                     ln=ln))
            t_bf = device_ms(lambda: gb.gablock_gemm(a, w, bias, relu=True))
            print(f'M={M} K={K} ({-(-K // 64)} chunks): LayerNorm epilogue '
                  f'{t_ln * 1e3:.1f} us, bf16 epilogue {t_bf * 1e3:.1f} us')


if __name__ == '__main__':
    main()
