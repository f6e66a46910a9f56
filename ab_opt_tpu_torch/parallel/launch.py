"""Start ranks on one host: ``spawn(fn, nprocs, backend, device)`` runs
``fn(*args)`` in ``nprocs`` fresh processes (``torch.multiprocessing``,
start method ``spawn``), each joined into one process group, and returns
each rank's return value.

The ranks rendezvous through a ``file://`` init method in a temporary
directory of their own, never a TCP port, so concurrent launches on one
host cannot collide. Rank r runs on ``cuda:(r % device_count)`` when
``device`` is ``'cuda'``. ``fn`` must be importable by name from a module
of this package (a child imports it afresh), and its return value is
pickled back through the same directory, so it should hold CPU tensors,
numpy arrays or plain Python values.

Kernels are built in the calling process before CUDA ranks start: ranks
that compiled at first use would race to write the same libraries.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: ``cuda:(rank % device_count)`` for a
    CUDA ``device`` without an index, ``device`` itself otherwise."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', rank % torch.cuda.device_count())
    return device


def check_backend(backend: str, nprocs: int, device) -> None:
    """Refuse what a backend cannot do, before any rank starts: ``nccl``
    needs one card a rank (it refuses two ranks on one card) and CUDA
    tensors."""
    device = torch.device(device)
    if backend == 'nccl':
        if device.type != 'cuda':
            raise ValueError('the nccl backend runs on CUDA devices only; '
                             'use --dist_backend gloo for the CPU')
        n = torch.cuda.device_count()
        if nprocs > n:
            raise ValueError(
                f'nccl needs one CUDA device a rank, and {nprocs} ranks see '
                f'{n}: NCCL refuses two ranks on one card ("Duplicate GPU '
                'detected"); pass --dist_backend gloo to share cards')
    elif backend != 'gloo':
        raise ValueError(f'unknown backend {backend!r} (nccl or gloo)')


def _rank_entry(rank: int, fn: Callable, nprocs: int, backend: str, device,
                tmp: str, args: Sequence, threads: Optional[int],
                timeout_s: float):
    from .distributed import init_distributed
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    init_distributed(backend, f'file://{os.path.join(tmp, "rendezvous")}',
                     nprocs, rank, timeout_s=timeout_s)
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f'result_{rank}.pkl'), 'wb') as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn: Callable, nprocs: int, backend: str = 'gloo', device='cpu',
          args: Sequence = (), threads: Optional[int] = None,
          timeout_s: float = 1800.0, wall_s: Optional[float] = None) -> List:
    """Run ``fn(*args)`` in ``nprocs`` ranks of one process group and return
    their return values, rank 0 first. ``threads`` caps each rank's CPU
    threads; ``timeout_s`` bounds every collective (a rank that never
    arrives fails the others instead of hanging them); ``wall_s``, when
    given, bounds the whole run: the ranks are killed and TimeoutError
    raised past it. With a CUDA ``device`` every kernel is compiled here
    first. Raises when any rank raises."""
    check_backend(backend, nprocs, device)
    if torch.device(device).type == 'cuda':
        from ..ops.build import build_all
        build_all()
    with tempfile.TemporaryDirectory(prefix='ab_opt_ranks_') as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, nprocs, backend, device, tmp, tuple(args),
                               threads, timeout_s),
            nprocs=nprocs, join=False, start_method='spawn')
        deadline = None if wall_s is None else time.monotonic() + wall_s
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f'{nprocs} ranks of {fn.__name__} still '
                                   f'running after {wall_s} s; killed')
        results = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f'result_{rank}.pkl'), 'rb') as f:
                results.append(pickle.load(f))
    return results
