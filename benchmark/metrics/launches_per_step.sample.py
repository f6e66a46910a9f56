"""Device kernels a reverse step: every kernel of the traced requests
over their reverse steps."""


def read(view):
    steps = view.counts.get('steps')
    if not steps or not view.kernels:
        return None
    return len(view.kernels) / steps
