"""The traced sampler requests that ran K1, read from the program's span
record: each closed ``sample`` span whose plan names K1's attention tile
(``k1_attn_qt`` and ``k1_attn_rows``; a program that records no plan
gives none), with the number of reverse steps it ran (its closed
``sample.step`` children)."""
from __future__ import annotations

from typing import List, Tuple


def k1_requests() -> List[Tuple[dict, int]]:
    """(the ``sample`` span's attributes, its steps) of each traced K1
    request; empty where the program records no such span."""
    try:
        from ab_opt_tpu_torch.utils.profiling import recorded
    except ImportError:
        return []
    spans = recorded()
    steps = {i: 0 for i, s in enumerate(spans)
             if s.name == 'sample' and s.end is not None
             and {'k1_attn_qt', 'k1_attn_rows'} <= s.attrs.keys()}
    for s in spans:
        if s.name == 'sample.step' and s.parent in steps and s.end is not None:
            steps[s.parent] += 1
    return [(spans[i].attrs, n) for i, n in steps.items() if n]
