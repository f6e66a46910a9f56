"""The device's idle time inside the reverse loop: the length of the
traced ``sample.step`` spans not covered by the union of the device's
operations, over the traced window. None where the program records no
such span, or the trace no device operation."""
import bisect


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    steps = [s for s in recorded()
             if s.name == 'sample.step' and s.end is not None]
    if not steps or not view.device_ops or view.window_s <= 0:
        return None
    busy = _union((t, t + d) for _, t, d in view.device_ops)
    ends = [e for _, e in busy]
    idle = 0
    for s in steps:
        idle += s.end - s.start
        i = bisect.bisect_right(ends, s.start)
        while i < len(busy) and busy[i][0] < s.end:
            idle -= min(busy[i][1], s.end) - max(busy[i][0], s.start)
            i += 1
    return 100.0 * idle * 1e-9 / view.window_s
