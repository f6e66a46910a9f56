"""Batched sampling with on-device backbone reconstruction (counterpart of
``ab_opt_tpu/runners/design.py::BatchedSampler``, sample branch)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.collate import to_device_batch
from ..geometry import reconstruct_backbone_partially, so3vec_to_rotation
from ..models.diffab import DiffAb
from ..utils.device import resolve_device


class BatchedSampler:
    """One design request: sample ``num_replicas`` trajectories per complex
    of a batch, rebuild their backbones on the device, return numpy.

    ``device=None`` runs on the CUDA card (and raises without one); pass
    ``device='cpu'`` to run on the CPU. The model is moved there."""

    def __init__(self, model: DiffAb, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)

    def __call__(self, batch: Dict, seed: int,
                 num_replicas: int = 1) -> Dict[str, np.ndarray]:
        device = self.device
        batch = to_device_batch(batch, device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        out = self.model.sample(batch, generator=generator,
                                num_replicas=num_replicas)
        # Tile the context batch to the trajectory axis (sample() encodes
        # once and fans out internally; replicas are contiguous per complex).
        B = out['s'].shape[0]
        tile = lambda x: x.repeat_interleave(B // x.shape[0], dim=0)
        pos_new, mask_new = reconstruct_backbone_partially(
            tile(batch['pos_heavyatom']), so3vec_to_rotation(out['v']),
            out['p'], out['s'], tile(batch['chain_nb']), tile(batch['res_nb']),
            tile(batch['mask_heavyatom']), tile(batch['generate_flag']))
        out['pos_atom_new'] = pos_new
        out['mask_atom_new'] = mask_new
        return {k: v.cpu().numpy() for k, v in out.items()}
