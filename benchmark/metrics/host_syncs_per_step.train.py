"""The host's waits for the device a step: the synchronising CUDA runtime
calls (stream, device and event synchronisations, blocking copies) that
start inside a traced ``train.step`` span, over the steps. None where
the program records no such span."""
import bisect

SYNCS = frozenset(('cudaStreamSynchronize', 'cudaDeviceSynchronize',
                   'cudaEventSynchronize', 'cudaMemcpy'))


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    steps = [s for s in recorded()
             if s.name == 'train.step' and s.end is not None]
    if not steps:
        return None
    starts = sorted(t for n, t, _ in view.host_ops if n in SYNCS)
    n = sum(bisect.bisect_left(starts, s.end)
            - bisect.bisect_left(starts, s.start) for s in steps)
    return n / len(steps)
