"""One ``torch.profiler`` session over a few calls of the window, read in
memory (no trace file is written): the device's operations, the union of
their intervals (busy time), the device kernels by name, and the longest
idle gaps by what the host was doing. Only one session a process: a
second one may record no device events."""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric's reader reads."""
    kernels: List[Tuple[str, int, int]]   # (name, start ns, duration ns)
    device_ops: List[Tuple[str, int, int]]  # with copies and sets
    host_ops: List[Tuple[str, int, int]]
    window_s: float
    busy_s: float
    counts: Dict[str, float]              # 'steps': reverse or optimizer steps
    cell: object                          # harness.manifest.Cell
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, pattern: str) -> Optional[float]:
        """Device seconds of the kernels whose name matches ``pattern``
        (a regular expression), None if none ran."""
        rx = re.compile(pattern)
        hits = [d for n, _, d in self.kernels if rx.search(n)]
        return sum(hits) * 1e-9 if hits else None


def _union_ns(intervals) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of [start, end) intervals, and the gaps
    between its pieces."""
    total, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


class Session:
    """``with Session() as s: ...`` profiles the block; ``s.view(...)``
    reads it. The block's host time, between two synchronisations, is
    the traced window."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def view(self, cell, counts: Dict[str, float],
             flops: Optional[Dict[str, float]] = None) -> TraceView:
        from torch.autograd import DeviceType
        kernels, device_ops, host_ops = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns(), e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                device_ops.append(item)
                if not e.name().startswith(('Memcpy', 'Memset')):
                    kernels.append(item)
            elif not e.is_user_annotation():
                host_ops.append(item)
        busy_ns, _ = _union_ns((s, s + d) for _, s, d in device_ops)
        return TraceView(kernels, device_ops, host_ops, self.window_s,
                         busy_ns * 1e-9, counts, cell, flops or {})


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def breakdown(view: TraceView) -> Dict[str, list]:
    """The device operations with the most time, and the idle gaps of the
    device summed by the innermost host operation running at each gap's
    middle ('host' where none ran): at most ten of each, seconds."""
    by_name = defaultdict(int)
    for n, _, d in view.device_ops:
        by_name[n[:160]] += d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    _, gaps = _union_ns((s, s + d) for _, s, d in view.device_ops)
    host = sorted(view.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = defaultdict(int)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        # The innermost op covering the middle: the latest start among
        # those still running (scan back a bounded distance).
        for j in range(i - 1, max(-1, i - 2000), -1):
            n, s, d = host[j]
            if s + d >= mid:
                best = n
                break
        idle[(best or 'host')[:160]] += g1 - g0
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {'device_ops': [[n, d * 1e-9] for n, d in ops],
            'idle_gaps': [[n, d * 1e-9] for n, d in gaps_out]}
