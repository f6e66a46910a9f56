"""Batched sampling with on-device backbone reconstruction (counterpart of
``ab_opt_tpu/runners/design.py::BatchedSampler``): full sampling, strided
sampling and the optimize path."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.collate import to_device_batch
from ..geometry import reconstruct_backbone_partially, so3vec_to_rotation
from ..models.diffab import DiffAb
from ..parallel.mesh import replicate_batch
from ..utils.device import resolve_device


def _to_numpy(out: Dict) -> Dict:
    return {k: _to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in out.items()}


class BatchedSampler:
    """One design request: ``num_replicas`` trajectories per complex of a
    batch, their backbones rebuilt on the device, returned as numpy.

    ``sample_structure`` / ``sample_sequence`` choose what is generated (the
    other modality stays native: docking samples structure only, sequence
    design sequence only); ``keep_traj`` adds every step's state under
    'traj'; ``opt_step`` switches to the optimize path (noise the native
    state to that step, then denoise); ``stride`` > 1 samples with strided
    (DDIM) steps.

    ``device=None`` runs on the CUDA card (and raises without one); pass
    ``device='cpu'`` to run on the CPU. The model is moved there."""

    def __init__(self, model: DiffAb, device=None,
                 sample_structure: bool = True, sample_sequence: bool = True,
                 keep_traj: bool = False, opt_step: Optional[int] = None,
                 stride: int = 1):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.sample_structure = sample_structure
        self.sample_sequence = sample_sequence
        self.keep_traj = keep_traj
        self.opt_step = opt_step
        self.stride = stride

    def __call__(self, batch: Dict, seed: int,
                 num_replicas: int = 1) -> Dict[str, np.ndarray]:
        device = self.device
        batch = to_device_batch(batch, device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        flags = dict(sample_structure=self.sample_structure,
                     sample_sequence=self.sample_sequence,
                     keep_traj=self.keep_traj)
        if self.opt_step is not None:
            # The optimize path starts from the native state: replicate the
            # batch (no encode fan-out there).
            if num_replicas > 1:
                batch = replicate_batch(batch, num_replicas)
            out = self.model.optimize(batch, self.opt_step,
                                      generator=generator, **flags)
        else:
            out = self.model.sample(batch, generator=generator,
                                    num_replicas=num_replicas,
                                    stride=self.stride, **flags)
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
        return _to_numpy(out)
