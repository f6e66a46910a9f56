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


class DeviceCopies:
    """Host constants by name (numpy arrays, numbers, tuples of them) as
    tensors on the devices they are used on: the first use on a device
    copies a constant there and keeps the copy; later uses find it. On the
    card ``torch.as_tensor`` of host data is a copy from pageable memory,
    which makes the host wait for the device (and cannot run inside a CUDA
    graph's capture); a kept copy costs that once a device. The owner of
    the constants holds one; a copy or a pickle of the owner starts with
    no device copies. Treat what it returns as read-only."""

    def __init__(self, host: dict):
        self.host = dict(host)
        self._kept = {}

    def __reduce__(self):
        return DeviceCopies, (self.host,)

    def __call__(self, name: str, device, dtype=None) -> torch.Tensor:
        """The constant ``name`` as a tensor on ``device`` (of ``dtype``,
        else the host value's own)."""
        key = (name, torch.device(device), dtype)
        kept = self._kept.get(key)
        if kept is None:
            kept = self._kept[key] = torch.as_tensor(
                self.host[name], dtype=dtype, device=device)
        return kept
