"""The share of the traced training steps that replayed a CUDA graph:
``train.step`` spans whose ``graph`` is 'replay', over those that carry a
``graph`` ('eager', 'capture' or 'replay'), %. None where the program
records no such span."""


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    modes = [s.attrs['graph'] for s in recorded()
             if s.name == 'train.step' and s.end is not None
             and 'graph' in s.attrs]
    if not modes:
        return None
    return 100.0 * modes.count('replay') / len(modes)
