"""The denoiser glue's launches a reverse step: the kernel and graph
launches (CUDA runtime and driver calls; a graph launch counts once) that
start inside a traced ``sample.step`` span and outside its
``denoiser.encoder`` child, over the steps. None where the program
records no such span."""
import bisect

LAUNCHES = frozenset(('cudaLaunchKernel', 'cudaLaunchKernelExC',
                      'cuLaunchKernel', 'cuLaunchKernelEx',
                      'cudaLaunchCooperativeKernel', 'cudaGraphLaunch'))


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded()
    steps = {i for i, s in enumerate(spans)
             if s.name == 'sample.step' and s.end is not None}
    if not steps:
        return None
    starts = sorted(t for n, t, _ in view.host_ops if n in LAUNCHES)
    inside = lambda s: (bisect.bisect_left(starts, s.end)
                        - bisect.bisect_left(starts, s.start))
    n = sum(inside(spans[i]) for i in steps)
    n -= sum(inside(s) for s in spans
             if s.name == 'denoiser.encoder' and s.parent in steps
             and s.end is not None)
    return n / len(steps)
