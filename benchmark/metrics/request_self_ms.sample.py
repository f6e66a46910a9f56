"""The sampler's own time a request: the mean length of the traced
requests' ``sample`` spans (``DiffAb.sample``) less their ``sample.step``
children (the encode, the tiling, the initial noise, ``prepare_denoiser``'s
bundles and biases, the output stacks), ms. None where the program
records no such span."""


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans = recorded()
    own = {i: s.end - s.start for i, s in enumerate(spans)
           if s.name == 'sample' and s.end is not None}
    if not own:
        return None
    for s in spans:
        if s.name == 'sample.step' and s.parent in own and s.end is not None:
            own[s.parent] -= s.end - s.start
    return sum(own.values()) / len(own) * 1e-6
