"""Device kernels an optimizer step: every kernel of the traced steps
(loss, backward, clip, Adam, the finite check) over the steps."""


def read(view):
    steps = view.counts.get('steps')
    if not steps or not view.kernels:
        return None
    return len(view.kernels) / steps
