"""The optimizer's launches a step: the kernel and graph launches (CUDA
runtime and driver calls; a graph launch counts once) that start inside
a traced ``train.optimizer`` span (the gradients' all-reduce, the clip,
``optimizer.step()``, the losses' reduction and finite flag), over those
spans. None where the program records no such span."""
import bisect

LAUNCHES = frozenset(('cudaLaunchKernel', 'cudaLaunchKernelExC',
                      'cuLaunchKernel', 'cuLaunchKernelEx',
                      'cudaLaunchCooperativeKernel', 'cudaGraphLaunch'))


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = [s for s in recorded()
             if s.name == 'train.optimizer' and s.end is not None]
    if not spans:
        return None
    starts = sorted(t for n, t, _ in view.host_ops if n in LAUNCHES)
    n = sum(bisect.bisect_left(starts, s.end)
            - bisect.bisect_left(starts, s.start) for s in spans)
    return n / len(spans)
