"""Multi-process wiring on ``torch.distributed`` (counterpart of
``ab_opt_tpu/parallel/distributed.py``).

One process a rank, each holding one device (ranks may share a card under
the ``gloo`` backend). The pieces:

* :func:`init_distributed`: process bootstrap (a no-op for one process);
* :class:`Mesh` and :func:`world_mesh`: the 1-D ``dp`` axis over ranks, as
  rank and size arithmetic over a process group;
* :func:`host_batch_slice`: the contiguous rows of the global batch a rank
  owns; :func:`global_batch_from_host_shards`: those rows on the rank's
  device, with no copy between ranks;
* :func:`assert_replicated_params_equal`: a cross-rank checksum of the
  parameters;
* :func:`global_batch_sums` and :func:`global_sum`: inside the context,
  the sums a model takes over the batch axis span every rank's rows (the
  masked means of ``models/losses.py`` and the graph model's edge-feature
  norms in ``nn/egnn.py``), so that each rank's loss is its share of the
  global batch's.

The ``gloo`` backend all-reduces and broadcasts CUDA tensors (through the
host) but gathers only CPU ones, so the gathers here go through the CPU
under ``gloo``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel axis: ``size`` ranks, this process at ``rank``.
    ``group`` is the process group the collectives run over; ``None`` means
    one process with no collectives at all. A rank outside the mesh has
    ``rank`` -1."""
    size: int = 1
    rank: int = 0
    group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def barrier(self):
        if self.distributed:
            dist.barrier(group=self.group)

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the mesh in place; returns it."""
        if self.distributed:
            dist.all_reduce(x, group=self.group)
        return x

    def comm_device(self, device) -> torch.device:
        """Where a gathered tensor must live: the CPU under ``gloo``."""
        if self.distributed and dist.get_backend(self.group) == 'gloo':
            return torch.device('cpu')
        return torch.device(device)


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join this process into a group of ranks.

    Returns True when a process group is (or already was) initialised and
    False for the one-process fallback: no ``init_method`` or
    ``world_size`` given and no ``WORLD_SIZE`` above 1 in the environment
    (as ``torchrun`` sets it). Safe to call twice. ``backend`` defaults to
    ``nccl`` when CUDA is available, ``gloo`` otherwise."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None:
        if int(os.environ.get('WORLD_SIZE', '1')) <= 1:
            return False
        init_method = 'env://'
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    kw = {}
    if timeout_s is not None:
        kw['timeout'] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return True


def world_mesh() -> Mesh:
    """The 1-D mesh over every rank of the job (the default group), or the
    one-process mesh when no group is initialised."""
    if not dist.is_initialized():
        return Mesh()
    return Mesh(dist.get_world_size(), dist.get_rank(), dist.group.WORLD)


global_mesh = world_mesh          # the JAX package's name


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return world_mesh() if mesh is None else mesh


def host_batch_slice(global_batch_size: int,
                     mesh: Optional[Mesh] = None) -> slice:
    """The rows of the global batch this rank owns: contiguous, by rank.
    The global batch size must divide over the ranks (the training loader
    pads its batches to a fixed size)."""
    mesh = _mesh(mesh)
    if global_batch_size % mesh.size:
        raise ValueError(f'global batch {global_batch_size} not divisible by '
                         f'{mesh.size} ranks')
    per = global_batch_size // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def take_rows(batch: Dict, rows: slice) -> Dict:
    """The rows ``rows`` of every entry of a collated batch (arrays,
    tensors and per-item lists alike)."""
    return {k: v[rows] for k, v in batch.items()}


def global_batch_from_host_shards(local_batch: Dict, device=None) -> Dict:
    """This rank's rows of the global batch (numpy or tensors, equal keys
    and shapes on every rank but for the leading axis), as tensors on the
    rank's device: the global batch is their concatenation in rank order
    and no rows move between ranks. ``device`` defaults to the current
    CUDA device, or the CPU without one."""
    from ..data.collate import to_device_batch
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device('cpu'))
    return to_device_batch(local_batch, device)


def _tensors(module_or_state):
    if isinstance(module_or_state, torch.nn.Module):
        return list(module_or_state.state_dict().values())
    if isinstance(module_or_state, dict):
        return [v for v in module_or_state.values() if torch.is_tensor(v)]
    return list(module_or_state)


def assert_replicated_params_equal(module_or_state,
                                   mesh: Optional[Mesh] = None) -> None:
    """Cross-rank agreement check of a module's state (or a state dict):
    every rank all-gathers one float64 checksum a tensor; a mismatch raises
    on every rank."""
    mesh = _mesh(mesh)
    tensors = _tensors(module_or_state)
    if not (tensors and mesh.distributed):
        return
    checksum = torch.stack([t.detach().double().sum() for t in tensors])
    checksum = checksum.to(mesh.comm_device(checksum.device))
    gathered = [torch.empty_like(checksum) for _ in range(mesh.size)]
    dist.all_gather(gathered, checksum, group=mesh.group)
    rows = np.stack([g.cpu().numpy() for g in gathered])
    if not np.allclose(rows, rows[0], rtol=1e-6, atol=1e-6):
        bad = np.nonzero(~np.isclose(rows, rows[0], rtol=1e-6,
                                     atol=1e-6).all(0))[0]
        raise AssertionError(
            f'params diverged across ranks: {len(bad)} of {len(tensors)} '
            f'tensors differ (first at index {int(bad[0])})')


# ------------------------------------------------ sums over the global batch

# The mesh of the innermost global_batch_sums in this thread (a sampler or
# loader thread running beside a step never sees it).
_active = threading.local()


@contextlib.contextmanager
def global_batch_sums(mesh: Optional[Mesh]):
    """Inside this context the sums the models take over the batch axis
    span every rank's rows of ``mesh`` (one SUM all-reduce each): the
    losses' masked means divide by the mask's global count, so each rank's
    loss is its numerator over that count and the ranks' losses, and their
    gradients, sum to the global batch's; the graph model's edge features
    are normalised over every rank's edges. Without a process group the
    context changes nothing."""
    previous = getattr(_active, 'mesh', None)
    _active.mesh = mesh if mesh is not None and mesh.distributed else None
    try:
        yield
    finally:
        _active.mesh = previous


class _GlobalSum(torch.autograd.Function):
    """SUM all-reduce whose backward all-reduces the gradient: each rank's
    input then receives the gradient of every rank's use of the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone()), None


def global_sum(x: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """``x`` summed over the ranks of the active :func:`global_batch_sums`
    (``x`` itself outside one): detached, or with ``differentiable`` a sum
    that carries its gradient back to every rank."""
    mesh = getattr(_active, 'mesh', None)
    if mesh is None:
        return x
    if differentiable:
        return _GlobalSum.apply(x, mesh)
    return mesh.all_reduce_(x.detach().clone())
