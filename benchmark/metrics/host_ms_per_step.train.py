"""The host's time an optimizer step: the mean length of the traced
steps' ``train.step`` spans (``Trainer.train_step``, the deferred finite
check of the step before included), ms. None where the program records
no such span."""


def read(view):
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    steps = [s for s in recorded()
             if s.name == 'train.step' and s.end is not None]
    if not steps:
        return None
    return sum(s.end - s.start for s in steps) / len(steps) * 1e-6
