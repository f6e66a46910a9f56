"""The host's time a K1 layer: the mean length of the traced requests'
``k1.layer`` spans (``gablock_layer`` on the card: the checks, the
workspace and the launches), us. None where the program records no such
span (the K5 and K4 routes run none)."""


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    layers = [s for s in recorded()
              if s.name == 'k1.layer' and s.end is not None]
    if not layers:
        return None
    return sum(s.end - s.start for s in layers) / len(layers) * 1e-3
