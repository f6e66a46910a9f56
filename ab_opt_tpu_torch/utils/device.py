"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card; the
    CPU only when the caller asks for it. Raises when a CUDA device is asked
    for (or implied) and none is available."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run on the CPU')
    return device
