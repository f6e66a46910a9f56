"""What a run refuses: too few cards, and the JAX package or JAX itself
loaded in the process that prints the result."""
from __future__ import annotations

import sys

# Compared with each loaded module's top-level name (the part before the
# first dot), whole: the port's name begins with the JAX package's.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ab_opt_tpu')


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``)."""
    tops = {name.split('.')[0] for name in (modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def require_cards(n: int):
    """Raise unless this process sees at least ``n`` CUDA devices."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('benchmark: no CUDA device (torch.cuda.is_available() '
                         'is false)')
    if torch.cuda.device_count() < n:
        raise SystemExit(f'benchmark: the cell needs {n} CUDA devices, '
                         f'{torch.cuda.device_count()} visible')
