"""The host's time a reverse step: the mean length of the traced
requests' ``sample.step`` spans (``DiffAb.reverse_step``), ms. None
where the program records no such span."""


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    steps = [s for s in recorded()
             if s.name == 'sample.step' and s.end is not None]
    if not steps:
        return None
    return sum(s.end - s.start for s in steps) / len(steps) * 1e-6
