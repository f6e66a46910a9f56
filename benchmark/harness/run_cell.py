"""One run of one cell: set-up, the measured window, the trace's
per-layer metrics, the program's state freed, then the output check.
Returns the result line's object."""
from __future__ import annotations

import time

import torch

from .manifest import Cell, metric_reader
from .sample import SampleDriver
from .train import TrainDriver

DRIVERS = {'sample': SampleDriver, 'train': TrainDriver}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): the numbers the cell's limits name, each at or
    under its limit. A limit with no number, or no limit at all, fails."""
    checks = {n: {'value': numbers.get(n), 'limit': lim}
              for n, lim in limits.items()}
    ok = bool(checks) and all(c['value'] is not None
                              and c['value'] <= c['limit']
                              for c in checks.values())
    return ok, checks


def device_info(device, count: int) -> dict:
    if device == 'cpu' or not torch.cuda.is_available():
        return {'platform': 'cpu', 'kind': 'cpu', 'count': count,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated())}


def build_kernels(sources) -> float:
    """Compile the program's kernel sources that the cell runs (its
    traffic's ``kernels``, files of the port's ``csrc/``) where the
    checkout has not built them yet; the seconds nvcc took, 0 when every
    one was built."""
    if not sources:
        return 0.0
    from ab_opt_tpu_torch.ops import build
    built = build.build_sources([build.CSRC_DIR / s for s in sources],
                                build.BUILD_DIR)
    return max(r['seconds'] for r in built.values())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """The result line's object. ``setup_s`` runs from ``t_start`` to the
    first timed call, a first run's compilation included; ``build_s``
    (outside ``metrics``) is that compilation alone."""
    build_s = build_kernels(cell.traffic.get('kernels', []))
    driver = DRIVERS[cell.traffic['kind']](cell, seed, device)
    driver.setup()
    if device != 'cpu' and torch.cuda.is_available():
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    trace_calls = int(cell.traffic.get('trace_calls', 1)) if trace else 0
    e2e, attempted, failed, session = driver.window(seconds, trace_calls)
    dev = device_info(device, cell.chips)
    result = {'correct': False, 'attempted': attempted, 'failed': failed,
              'build_s': build_s}
    if trace:
        from .trace import breakdown
        view = session.view(cell, driver.counts(), driver.flops())
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m['name'])(view)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
        result['breakdown'] = breakdown(view)
    else:
        e2e['setup_s'] = setup_s
        units = {m['name']: m['unit'] for m in cell.end_to_end}
        metrics = {n: {'value': v, 'unit': units[n]} for n, v in e2e.items()
                   if n in units}
    result.update(metrics=metrics, device=dev)
    driver.release()
    numbers = driver.check()
    result['correct'], result['checks'] = judge(numbers, cell.limits)
    # The checks' key last: a reader that keeps only the end of the line
    # still sees them.
    result['checks'] = result.pop('checks')
    return result
