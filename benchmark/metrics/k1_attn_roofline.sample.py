"""K1's attention launch's share of its roofline: the least time of the
traced requests' ``k1_attn_kernel`` launches (the larger of their
operations over 989 TFLOP/s and their bytes over 3.35 TB/s) over those
launches' device time, %. Each launch is one layer of one reverse step;
its shape (N, L, heads, reps) comes from the ``sample`` span of its
request, weighted by the requests' steps where they differ. None where
the trace holds no such launch or the program records no K1 plan."""
import re

from harness.flops import BF16, bound_s
from harness.k1_spans import k1_requests

QK, V, P, PV = 32, 32, 8, 8   # the only head geometry K1 takes
KERNEL = r'\bk1_attn_kernel\b'


def attention_flops(N: int, L: int, H: int) -> float:
    """One launch over N trajectories of L residues and H heads: the
    logits over QK + 3P + 2 terms a pair (query against key, query points
    against key points, the points' two squared norms), then alpha times
    V + 3PV values a pair."""
    return 2 * N * H * L * L * ((QK + 3 * P + 2) + (V + 3 * PV))


def attention_bytes(N: int, L: int, H: int, reps: int) -> float:
    """One launch's bf16 bytes, each read or written once: qa, ka, vv in
    and o out (N, L, H * 64 each), alpha out (N, H, L, L) and the bias
    (H, L, L) once a complex (N / reps complexes)."""
    rows = N * L * H * 64
    return (4 * rows + N * H * L * L + (N // reps) * H * L * L) * BF16


def read(view):
    requests = k1_requests()
    rx = re.compile(KERNEL)
    times = [d for n, _, d in view.kernels if rx.search(n)]
    if not requests or not times:
        return None
    steps = sum(n for _, n in requests)
    per_launch = sum(
        n * bound_s(attention_flops(a['N'], a['L'], a['heads']),
                    attention_bytes(a['N'], a['L'], a['heads'], a['reps']))
        for a, n in requests) / steps
    return 100.0 * len(times) * per_launch / (sum(times) * 1e-9)
