"""Time the attention variants (S1-S3) against K2, K4 and the library.

Counterpart of ``scripts/micro_kernel_variants.py:184-227``: at the script's
shape (N=256 replicas of one complex, L=128, H=12, Cz=64, bf16, seeded
random operands) it prints ms per call, from CUDA events around ``iters``
calls after one warm-up, of

* v0, K2 (``ipa_attention_fwd``: in bf16 K1's tile, alphas out);
* v1 (K1's attention tile, alphas out in K2's layout), v2 (every head in
  one block: TMA-fed, warp-specialised wgmma; alphas out), v3 (v1 without
  the alphas) and v4 (K4's function in one launch: K1's tile with alpha in
  shared memory, p2n across a cluster);
* K4 (``ipa_attention_fwd_p2n``), the production kernel of v4's function;
* the p2n einsum over K2's alphas (``ipa_attention.p2n_aggregate``, the
  script's "XLA p2n" line);
* ``torch.nn.functional.scaled_dot_product_attention`` computing v3's out
  (``scale=1.0``, since qa arrives scaled; the bias as an additive mask),
  the library yardstick. It is timed here and used nowhere in the port.

It first prints the card's name and power limit. Run from the repository
root on a machine with an NVIDIA GPU:

    python -m ab_opt_tpu_torch.utils.micro_attention

``--launches`` prints instead, as one JSON line, the device kernels of one
v4 call and of one v2 call at that shape under ``torch.profiler`` (a
profiler session after another in one process may record no device
events, so callers run it in a process of its own).
"""
from __future__ import annotations

import json
import subprocess
import sys

REPS, LENGTH, HEADS, CZ, ITERS = 256, 128, 12, 64, 20


def make_operands(N, reps, L, H, Cz, device, seed=0, n_pad=0):
    """Seeded bf16 operands qa, ka, vvp, bias, z; with ``n_pad`` the last
    key columns carry -1e5 in the bias (padded residues)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g,
                                          device=device) * scale
    HD = H * 64
    qa, ka, vvp = r(N, L, HD, scale=0.5), r(N, L, HD, scale=0.5), r(N, L, HD)
    bias = r(N // reps, H, L, L)
    if n_pad:
        bias[..., L - n_pad:] -= 1e5
    z = r(N // reps, L, L, Cz)
    return [a.to(torch.bfloat16).contiguous()
            for a in (qa, ka, vvp, bias, z)]


def sdpa_call(qa, ka, vvp, bias, reps):
    """The one library call computing v3's out, and the reshape to its
    (N, L, H*64) layout outside it: (call, to_layout)."""
    import torch
    N, L, HD = qa.shape
    H = HD // 64
    heads = lambda a: a.view(N, L, H, 64).transpose(1, 2)
    q, k, v = heads(qa), heads(ka), heads(vvp)
    mask = bias if bias.shape[0] == 1 else bias.repeat_interleave(reps, 0)
    call = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=1.0)
    return call, lambda o: o.transpose(1, 2).reshape(N, L, HD)


def cuda_ms(fn, iters):
    """ms per call of ``fn`` from CUDA events around ``iters`` calls, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_variants(qa, ka, vvp, bias, z, reps, iters=ITERS):
    """ms per call of every entry of the module docstring on these CUDA
    operands; keys 'v0', 'v1', 'v2', 'v3', 'v4', 'k4', 'p2n_einsum',
    'sdpa'. Raises without CUDA operands (nothing runs on the CPU)."""
    from ..ops import attention_variants as av
    from ..ops import ipa_attention as ia
    if not qa.is_cuda:
        raise RuntimeError('micro_attention: the operands must lie on a '
                           'CUDA device')
    alphas = ia.ipa_attention_fwd(qa, ka, vvp, bias, reps)[1]
    sdpa = sdpa_call(qa, ka, vvp, bias, reps)[0]
    calls = {
        'v0': lambda: ia.ipa_attention_fwd(qa, ka, vvp, bias, reps),
        'v1': lambda: av.attention_v1(qa, ka, vvp, bias, reps),
        'v2': lambda: av.attention_v2(qa, ka, vvp, bias, reps),
        'v3': lambda: av.attention_v1(qa, ka, vvp, bias, reps,
                                      store_alphas=False),
        'v4': lambda: av.attention_v4(qa, ka, vvp, bias, z, reps),
        'k4': lambda: ia.ipa_attention_fwd_p2n(qa, ka, vvp, bias, z, reps),
        'p2n_einsum': lambda: ia.p2n_aggregate(alphas, z, reps),
        'sdpa': sdpa}
    return {k: cuda_ms(fn, iters) for k, fn in calls.items()}


LABELS = {
    'v0': 'v0 K2 (ipa_attention_fwd, alphas out)',
    'v1': 'v1 K1 tile (alphas out)',
    'v2': 'v2 head loop, TMA + wgmma (alphas out)',
    'v3': 'v3 K1 tile, no alphas store',
    'v4': 'v4 K1 tile + cluster p2n, one launch',
    'k4': 'K4 (ipa_attention_fwd_p2n)',
    'p2n_einsum': 'p2n einsum (alphas read from HBM)',
    'sdpa': 'scaled_dot_product_attention (v3 out)'}


def variant_launches(ops, reps):
    """The device kernels of one v4 call and one v2 call on these CUDA
    operands, each after a warm-up call: {'v4': [(name, count), ...],
    'v2': [...]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops import attention_variants as av
    qa, ka, vvp, bias, z = ops
    calls = {'v4': lambda: av.attention_v4(qa, ka, vvp, bias, z, reps),
             'v2': lambda: av.attention_v2(qa, ka, vvp, bias, reps)}
    found = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        found[name] = [(e.key, e.count) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, 'is_user_annotation', False)]
    return found


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('micro_attention: needs a CUDA device')
    if '--launches' in sys.argv[1:]:
        torch.set_grad_enabled(False)
        ops = make_operands(REPS, REPS, LENGTH, HEADS, CZ,
                            torch.device('cuda'))
        print(json.dumps(variant_launches(ops, REPS)))
        return
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    torch.set_grad_enabled(False)
    ops = make_operands(REPS, REPS, LENGTH, HEADS, CZ, torch.device('cuda'))
    print(f'N={REPS}, reps={REPS}, L={LENGTH}, H={HEADS}, Cz={CZ}, bf16, '
          f'{ITERS} calls each')
    for key, ms in time_variants(*ops, REPS).items():
        print(f'{LABELS[key] + ":":44s}{ms:8.4f} ms')


if __name__ == '__main__':
    main()
