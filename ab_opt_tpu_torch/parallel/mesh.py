"""The data-parallel train step and the sharded sampling fan-out on
``torch.distributed`` (counterpart of ``ab_opt_tpu/parallel/mesh.py``).

* training: the batch is split by rows over the ranks of a 1-D ``dp`` mesh,
  the parameters are replicated; every sum a model takes over the batch
  axis spans the global batch (``distributed.global_batch_sums``: the
  masked means' counts, the graph model's edge norms), so a SUM
  all-reduce of the gradients (one flat buffer a step, after
  ``backward``) gives exactly the global batch's gradient, as the
  all-reduce XLA inserts into JAX's step does;
* sampling: the trajectory fan-out is split by rows, each rank samples its
  rows with its own generator and rank 0 gathers them: no collective runs
  during the reverse steps.

Without a process group (the one-process :class:`Mesh`) every collective
is skipped and the step is the one-device step.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from ..utils.profiling import span
from .distributed import (Mesh, global_batch_sums, host_batch_slice,
                          take_rows, world_mesh)


_SUB_GROUPS: Dict[int, object] = {}


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (all of them by default).
    Without a process group only one rank exists. Every rank of the job
    must call it (a sub-mesh is a new process group); a rank past
    ``n_devices`` gets rank -1."""
    world = world_mesh()
    if n_devices is None or n_devices == world.size:
        return world
    if n_devices > world.size:
        raise ValueError(
            f'make_mesh({n_devices}) but only {world.size} ranks exist; start '
            f'{n_devices} processes (parallel/launch.py::spawn, or the '
            'training CLI\'s --num_devices)')
    # One process group a sub-mesh size, made once (every rank must make
    # the same groups in the same order).
    if n_devices not in _SUB_GROUPS:
        _SUB_GROUPS[n_devices] = dist.new_group(list(range(n_devices)))
    rank = world.rank if world.rank < n_devices else -1
    return Mesh(n_devices, rank, _SUB_GROUPS[n_devices])


def dp_size_for_batch(batch_size: int, limit: int) -> int:
    """The largest rank count up to ``limit`` that divides ``batch_size``."""
    return max(d for d in range(1, max(1, limit) + 1) if batch_size % d == 0)


def auto_mesh_for_batch(batch_size: int,
                        n_devices: Optional[int] = None) -> Mesh:
    """Mesh over the largest rank count (up to ``n_devices``, else the
    world) that divides ``batch_size``."""
    limit = n_devices or world_mesh().size
    return make_mesh(dp_size_for_batch(batch_size, limit))


def _flat_broadcast_(tensors, mesh: Mesh, src: int = 0):
    """Broadcast ``tensors`` from ``src`` in place, one buffer a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=src, group=mesh.group)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def replicate(tree, mesh: Optional[Mesh] = None):
    """Make every rank hold rank 0's copy of a module's state (parameters
    and buffers) or of a dict of tensors, in place; returns ``tree``."""
    mesh = world_mesh() if mesh is None else mesh
    if not mesh.distributed:
        return tree
    tensors = (list(tree.state_dict().values())
               if isinstance(tree, torch.nn.Module)
               else [v for v in tree.values() if torch.is_tensor(v)])
    with torch.no_grad():
        _flat_broadcast_(tensors, mesh)
    return tree


def shard_batch(batch: Optional[Dict], mesh: Optional[Mesh] = None,
                device=None) -> Dict:
    """Rank 0's global batch (numpy or tensors; other ranks may pass
    ``None``) broadcast to every rank, which keeps its rows
    (:func:`host_batch_slice`) as tensors on ``device``."""
    from ..data.collate import to_device_batch
    mesh = world_mesh() if mesh is None else mesh
    if mesh.distributed:
        host = None if batch is None else {
            k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in batch.items()}
        box = [host]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        batch = box[0]
    n = len(next(iter(batch.values())))
    return to_device_batch(take_rows(batch, host_batch_slice(n, mesh)),
                           device or 'cpu')


def weighted_total(losses: Dict, weights: Optional[Dict]) -> torch.Tensor:
    """With explicit weights only the weighted terms train (the reference's
    sum_weighted_losses skips unweighted and no-grad entries, e.g. the
    graph model's 'accuracy'); without, every term counts once."""
    weights = weights or {}
    keys = [k for k in losses if k in weights] if weights else list(losses)
    return sum(losses[k] * weights.get(k, 1.0) for k in keys)


def all_reduce_grads_(params: Iterable[torch.nn.Parameter], mesh: Mesh):
    """Sum the gradients over the mesh in one float32 buffer. A parameter
    with no gradient on a rank counts as zeros there, so every rank joins
    the same collective; it keeps no gradient only where no rank has one
    (as one process skips it in the optimizer)."""
    if not mesh.distributed:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    dev = params[0].device
    parts = [(p.grad.reshape(-1).float() if p.grad is not None
              else torch.zeros(p.numel(), device=dev)) for p in params]
    present = torch.tensor([float(p.grad is not None) for p in params],
                           device=dev)
    flat = mesh.all_reduce_(torch.cat(parts + [present]))
    sums = flat[:-len(params)].split([p.numel() for p in params])
    for p, g, seen in zip(params, sums, flat[-len(params):].tolist()):
        p.grad = g.view_as(p).to(p.dtype) if seen > 0 else None


def reduce_losses(losses: Dict, mesh: Mesh) -> Dict:
    """The detached losses summed over the mesh in one all-reduce (each
    rank's masked means are its share of the global ones), with a
    '_finite' flag that is False on every rank when any rank's loss or any
    sum is not finite."""
    keys = list(losses)
    local = torch.stack([losses[k].detach().float() for k in keys])
    bad = (~torch.isfinite(local)).any().float()
    flat = mesh.all_reduce_(torch.cat([local, bad[None]]))
    out = dict(zip(keys, flat[:-1].unbind()))
    out['_finite'] = (flat[-1] == 0) & torch.isfinite(flat[:-1]).all()
    return out


def sharded_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       mesh: Optional[Mesh] = None,
                       loss_weights: Optional[Dict] = None,
                       max_grad_norm: Optional[float] = None) -> Callable:
    """Build a data-parallel train step over ``model.loss(batch, **kw)``, a
    dict of scalar losses. The returned ``step(batch, **kw)`` takes this
    rank's rows of the global batch (and ``kw``, e.g. this rank's rows of
    the draws), computes the losses inside ``global_batch_sums`` (each
    rank's share of the global batch's losses), runs backward, sums the
    gradients over the mesh, clips them to ``max_grad_norm`` on their
    global norm (``scale = min(1, max / (norm + 1e-6))``), steps the
    optimizer and returns the global losses (detached, 'overall' the
    weighted total) with a '_finite' flag."""
    mesh = world_mesh() if mesh is None else mesh
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict, **kw) -> Dict:
        optimizer.zero_grad(set_to_none=True)
        with global_batch_sums(mesh):
            losses = model.loss(batch, **kw)
        total = weighted_total(losses, loss_weights)
        total.backward()
        with span('train.optimizer'):
            all_reduce_grads_(params, mesh)
            if max_grad_norm is not None:
                torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
            optimizer.step()
            return reduce_losses(dict(losses, overall=total), mesh)

    return step


# Outputs of a sampler whose rows sit on axis 1: the per-step stacks and the
# trajectory (steps first).
ROW_AXIS = {'prmsd': 1, 'perplexity': 1, 'traj': 1}


def gather_rows(x, mesh: Mesh, axis: int = 0):
    """Rank 0: the rows of ``x`` from every rank, concatenated in rank order
    on ``x``'s device; other ranks: None. Dicts are gathered entry by
    entry."""
    if isinstance(x, dict):
        out = {k: gather_rows(v, mesh, axis) for k, v in x.items()}
        return out if mesh.rank == 0 else None
    if not mesh.distributed:
        return x
    send = x.contiguous().to(mesh.comm_device(x.device))
    parts = ([torch.empty_like(send) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(send, parts, dst=0, group=mesh.group)
    return torch.cat(parts, axis).to(x.device) if mesh.rank == 0 else None


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's sampling generator."""
    return seed + rank


def sharded_sample_fn(sample_fn: Callable, mesh: Optional[Mesh] = None,
                      **sample_kwargs) -> Callable:
    """Split a sampler's trajectory fan-out over the ranks.

    ``sample_fn(batch, generator=..., **kw)`` returns a dict of tensors
    with the rows on axis 0 (axis 1 for :data:`ROW_AXIS`'s entries). The
    returned ``sample(batch, seed)`` takes the whole fan-out on every rank
    (N divisible by the mesh size); each rank samples its rows
    (:func:`host_batch_slice`) with a generator seeded ``rank_seed(seed,
    rank)`` on the batch's device, and rank 0 returns every row (other
    ranks return None)."""
    def sample(batch: Dict, seed: int) -> Optional[Dict]:
        m = world_mesh() if mesh is None else mesh
        n = len(next(iter(batch.values())))
        local = take_rows(batch, host_batch_slice(n, m))
        dev = next(v.device for v in local.values() if torch.is_tensor(v))
        gen = torch.Generator(device=dev).manual_seed(rank_seed(seed, m.rank))
        out = sample_fn(local, generator=gen, **sample_kwargs)
        out = {k: gather_rows(v, m, ROW_AXIS.get(k, 0))
               for k, v in out.items()}
        return out if m.rank == 0 else None

    return sample


def replicate_batch(batch: Dict, num: int) -> Dict:
    """Tile a batch to ``num`` independent trajectories per complex, the
    replicas of a complex contiguous (the reference's DataLoader([data] *
    num) trick). Tensors with a batch axis are tiled; anything else passes
    through."""
    return {k: (v.repeat_interleave(num, dim=0)
                if torch.is_tensor(v) and v.dim() >= 1 else v)
            for k, v in batch.items()}
