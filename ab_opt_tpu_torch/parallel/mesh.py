"""Batch layout across trajectories (counterpart of
``ab_opt_tpu/parallel/mesh.py``; the device mesh itself is not ported
yet)."""
from __future__ import annotations

from typing import Dict

import torch


def replicate_batch(batch: Dict, num: int) -> Dict:
    """Tile a batch to ``num`` independent trajectories per complex, the
    replicas of a complex contiguous (the reference's DataLoader([data] *
    num) trick). Tensors with a batch axis are tiled; anything else passes
    through."""
    return {k: (v.repeat_interleave(num, dim=0)
                if torch.is_tensor(v) and v.dim() >= 1 else v)
            for k, v in batch.items()}
