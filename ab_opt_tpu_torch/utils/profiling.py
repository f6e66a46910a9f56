"""Profiling and determinism helpers (the port's copy of
``ab_opt_tpu/utils/profiling.py``): host-RNG seeding, a ``torch.profiler``
trace around a block, and a rolling step timer that waits for the device.
"""
from __future__ import annotations

import contextlib
import logging
import os
import random
import time
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def seed_all(seed: int):
    """Seed the host RNGs (``random`` and numpy). The port's device
    randomness comes from explicit generators."""
    random.seed(seed)
    np.random.seed(seed)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile a block with ``torch.profiler`` (the CPU, and CUDA when a card
    is present) and write a Chrome trace, ``<log_dir>/trace.json``. Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, 'trace.json')
        prof.export_chrome_trace(path)
        logger.info('profiler trace written to %s', path)


def _devices(tree):
    if torch.is_tensor(tree):
        yield tree.device
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _devices(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _devices(v)


class StepTimer:
    """Rolling per-step wall-clock timer; ``stop(block_on)`` first waits for
    the CUDA devices that hold ``block_on``'s tensors (a tensor or a
    dict/list of them)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, block_on=None) -> float:
        if block_on is not None:
            for dev in {d for d in _devices(block_on) if d.type == 'cuda'}:
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1e3 * (sum(self.times) / len(self.times)) if self.times else 0.0
