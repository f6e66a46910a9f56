"""Rank-side routines that drive the data-parallel path end to end, for
``launch.spawn``: the tests run them in gloo ranks on the CPU and
``chip_smoke.py`` in gloo ranks sharing one card (and in one NCCL rank).

``run_jobs(jobs)`` runs ``[(name, kwargs), ...]`` in order in every rank
and returns ``{name: result}``; the names are the keys of :data:`JOBS`. A
model is passed as ``(kind, config kwargs, state dict)`` with ``kind``
``'diffab'`` or ``'diff_gnn'``; batches and draws as numpy (or CPU
tensors) for the global batch, which each rank cuts to its rows. Results
are CPU values; the ones that only rank 0 holds are None elsewhere.
:func:`accumulate` runs in one process: the reference a data-parallel
step's gradient is held to where the compute dtype rounds each rank's
weight gradients.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.collate import to_device_batch
from .distributed import (Mesh, assert_replicated_params_equal,
                          global_batch_from_host_shards, global_batch_sums,
                          host_batch_slice, take_rows, world_mesh)
from .mesh import (auto_mesh_for_batch, gather_rows,
                   replicate, shard_batch, sharded_sample_fn,
                   sharded_train_step, weighted_total)


def _device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def build_model(spec, device):
    """``(kind, config kwargs, state dict or None)`` -> the model on
    ``device``."""
    from ..models import DiffAb, DiffAbConfig, DiffGNN, DiffGNNConfig
    kind, kw, state = spec
    cls, cfg = {'diffab': (DiffAb, DiffAbConfig),
                'diff_gnn': (DiffGNN, DiffGNNConfig)}[kind]
    model = cls(cfg(**kw))
    if state is not None:
        model.load_state_dict(state)
    return model.to(device)


def _rows_of_draws(draws, rows: slice, device):
    """This rank's rows of a global (t, draws) pair."""
    t, d = draws
    t = torch.as_tensor(np.asarray(t))[rows].to(device)
    return t, to_device_batch(take_rows(dict(d), rows), device)


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .float().reshape(-1) for p in model.parameters()]).cpu()


def _counts() -> Dict[str, int]:
    from ..ops import gablock
    from ..ops import ipa_attention as ia
    return {'K1': gablock.gablock_layer.launches,
            'K2': ia.ipa_attention_fwd.launches,
            'K3': ia.ipa_attention_bwd.launches,
            'plain': (gablock.gablock_layer_reference.calls
                      + ia.ipa_attention_fwd_reference.calls
                      + ia.ipa_attention_bwd_reference.calls)}


def _reset_counts():
    from ..ops import gablock
    from ..ops import ipa_attention as ia
    ia.reset_counts()
    gablock.gablock_layer.launches = 0
    gablock.gablock_layer_reference.calls = 0


def train(model: Sequence, train_cfg: Dict, batches: List[Dict],
          draws: Optional[List] = None, seed: int = 0, via: str = 'trainer',
          grads: bool = False, time_all_reduce: int = 0) -> Dict:
    """Data-parallel steps over every rank: one step a global batch of
    ``batches``, each rank on its rows. ``draws`` (one global (t, draws)
    pair a step) or, without them, the trainer's draws from a generator
    seeded ``seed`` + 1 (as ``Trainer.train`` seeds it). ``via`` 'trainer'
    steps ``Trainer.train_step``; 'step' a bare ``sharded_train_step`` with
    the trainer's optimizer. Returns per step the global losses, the
    launches of this rank, the parameters after the last step (rank 0)
    and, with ``grads``, the first step's reduced and clipped gradients
    (rank 0); the replicated-parameter check runs after the last step.
    ``time_all_reduce`` > 0 times that many all-reduces of a buffer the
    size of the gradients (ms each, the card synchronised)."""
    from ..train import Trainer, build_optimizer
    dev = _device()
    mesh = world_mesh()
    trainer = Trainer(build_model(model, dev), train_cfg, device=dev,
                      n_devices=mesh.size)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if via == 'step':
        opt = build_optimizer(trainer.model.parameters(),
                              train_cfg.get('optimizer', {}))
        step = sharded_train_step(trainer.model, opt, trainer.mesh,
                                  trainer.loss_weights, trainer.max_grad_norm)
    out = {'losses': [], 'launches': [], 'grads': None, 'seconds': []}
    for i, batch in enumerate(batches):
        n = len(batch['aa'])
        rows = host_batch_slice(n, trainer.mesh)
        local = take_rows(batch, rows)
        t, d = (_rows_of_draws(draws[i], rows, dev) if draws
                else (None, None))
        _reset_counts()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if via == 'step':
            if t is None:
                t, d = trainer.rank_draws(local, gen)
            losses = step(to_device_batch(local, dev), generator=gen, t=t,
                          draws=d)
            losses.pop('_finite')
        else:
            losses = trainer.train_step(local, gen, t=t, draws=d)
        values = {k: float(v) for k, v in losses.items()}
        out['seconds'].append(time.perf_counter() - t0)
        out['launches'].append(_counts())
        out['losses'].append(values)
        if grads and i == 0 and mesh.rank == 0:
            out['grads'] = _flat_grads(trainer.model)
    assert_replicated_params_equal(trainer.model, trainer.mesh)
    if mesh.rank == 0:
        out['state'] = {k: v.detach().cpu()
                        for k, v in trainer.model.state_dict().items()}
    if time_all_reduce:
        flat = torch.zeros(sum(p.numel() for p in trainer.model.parameters()),
                           device=dev)
        ms = []
        for _ in range(time_all_reduce + 1):
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            trainer.mesh.all_reduce_(flat)
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        out['all_reduce_ms'] = ms[1:]
        out['all_reduce_floats'] = flat.numel()
    return out


class _PartSums:
    """One process standing in for the ranks inside ``global_batch_sums``:
    each batch sum a part's loss takes gets ``others`` added, the other
    parts' values of the same sum in call order; every value it is given
    is recorded in ``seen``."""
    distributed = True

    def __init__(self, others=None):
        self.others, self.seen = others, []

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        self.seen.append(x.detach().clone())
        if self.others is not None:
            x += self.others[len(self.seen) - 1]
        return x


def accumulate(model: Sequence, train_cfg: Dict, batch: Dict, draws,
               parts: int = 2) -> Dict:
    """In one process, the gradient a data-parallel step over ``parts``
    ranks forms: each part's rows (a rank's) run the loss over the global
    batch's mask counts and their backward accumulates into the
    parameters' float32 ``.grad``, so each part's weight gradients are
    rounded to the compute dtype before the sum, as each rank's are before
    the all-reduce; then the clip of ``train_cfg``. For DiffAb, whose batch
    sums are mask counts with no gradient through them. Returns the losses
    (summed over the parts, 'overall' the weighted total) and the flat
    gradients."""
    from ..train import Trainer
    dev = _device()
    trainer = Trainer(build_model(model, dev), train_cfg, device=dev,
                      n_devices=1)
    m, n = trainer.model, len(batch['aa'])
    cuts = [host_batch_slice(n, Mesh(parts, p)) for p in range(parts)]
    inputs = [(to_device_batch(take_rows(batch, rows), dev),
               *_rows_of_draws(draws, rows, dev)) for rows in cuts]
    seen = []
    with torch.no_grad():
        for b, t, d in inputs:
            rec = _PartSums()
            with global_batch_sums(rec):
                m.loss(b, t=t, draws=d)
            seen.append(rec.seen)
    m.zero_grad(set_to_none=True)
    losses = {}
    for p, (b, t, d) in enumerate(inputs):
        others = [sum(s[i] for q, s in enumerate(seen) if q != p)
                  for i in range(len(seen[p]))]
        with global_batch_sums(_PartSums(others)):
            part = m.loss(b, t=t, draws=d)
        total = weighted_total(part, trainer.loss_weights)
        total.backward()
        for k, v in dict(part, overall=total).items():
            losses[k] = losses.get(k, 0.0) + float(v.detach())
    torch.nn.utils.clip_grad_norm_(
        [q for q in m.parameters() if q.requires_grad], trainer.max_grad_norm)
    return {'losses': losses, 'grads': _flat_grads(m)}


def dropout_streams(model: Sequence, train_cfg: Dict, batch: Dict, draws,
                    val_batches: List[Dict], seed: int = 0) -> Dict:
    """The loss's own draws (the graph model's dropout masks) under ranks:
    one ``Trainer`` step on this rank's rows of ``batch`` with its rows of
    ``draws``, then ``validate`` over ``val_batches`` (numpy; a size that
    does not divide over the ranks is rank 0's alone), the trainer's
    generator seeded ``seed`` + 1. Returns the losses of every loss call
    this rank made, as the loss returned them (this rank's share), the val
    loss and the trainer generator's next four draws."""
    from ..train import Trainer
    dev = _device()
    mesh = world_mesh()
    trainer = Trainer(build_model(model, dev), train_cfg, device=dev,
                      n_devices=mesh.size)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    seen, loss = [], trainer.model.loss

    def recording(*args, **kw):
        out = loss(*args, **kw)
        seen.append({k: float(v.detach()) for k, v in out.items()})
        return out

    trainer.model.loss = recording
    rows = host_batch_slice(len(batch['aa']), trainer.mesh)
    t, d = _rows_of_draws(draws, rows, dev)
    trainer.train_step(take_rows(batch, rows), gen, t=t, draws=d)
    val = trainer.validate(val_batches, gen)
    return {'local': seen, 'val': val,
            'next': torch.rand(4, generator=gen, device=dev).cpu()}


def shard_mean_losses(model: Sequence, batch: Dict, draws, weights: Dict):
    """The trap the global batch sums avoid: each rank's own masked means,
    averaged over the ranks (what ``DistributedDataParallel`` does with
    the gradients of such losses). Returns the averaged losses."""
    dev = _device()
    mesh = world_mesh()
    m = build_model(model, dev)
    rows = host_batch_slice(len(batch['aa']), mesh)
    t, d = _rows_of_draws(draws, rows, dev)
    losses = m.loss(to_device_batch(take_rows(batch, rows), dev), t=t,
                    draws=d)
    losses = dict(losses, overall=weighted_total(losses, weights))
    values = mesh.all_reduce_(torch.stack([v.detach() for v in
                                           losses.values()]))
    return dict(zip(losses, (values / mesh.size).tolist()))


def sample(model: Sequence, batch: Dict, seed: int,
           fanout: bool = False) -> Dict:
    """The fan-out ``batch`` (every row of it on every rank) through
    ``sharded_sample_fn(model.sample)``. With ``fanout`` the rows are copies
    of one complex and a rank samples its rows as ``num_replicas`` of its
    first row (the sampler's replica path). Returns rank 0's gathered
    outputs (CPU), this rank's launches and wall seconds."""
    dev = _device()
    m = build_model(model, dev)

    def sample_fn(local, generator, **kw):
        if fanout:
            n = len(local['aa'])
            local, kw = take_rows(local, slice(0, 1)), dict(kw, num_replicas=n)
        return m.sample(local, generator=generator, **kw)

    fn = sharded_sample_fn(sample_fn, world_mesh())
    _reset_counts()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn(to_device_batch(batch, dev), seed)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    cpu = lambda x: ({k: cpu(v) for k, v in x.items()} if isinstance(x, dict)
                     else x.cpu())
    return {'out': None if out is None else cpu(out), 'launches': _counts(),
            'seconds': seconds}


def helpers(batch: Dict, sizes: Sequence[int] = tuple(range(1, 17))) -> Dict:
    """This rank's view of the helpers: ``host_batch_slice`` (or its
    refusal) and ``auto_mesh_for_batch``'s size for each of ``sizes``;
    ``global_batch_from_host_shards`` of this rank's rows of ``batch``
    gathered back on rank 0; ``shard_batch`` of rank 0's ``batch`` against
    this rank's rows; ``replicate`` of a rank-dependent state;
    ``assert_replicated_params_equal`` on equal parameters and after rank 1
    perturbs one tensor."""
    mesh = world_mesh()
    slices, meshes = {}, {}
    for n in sizes:
        try:
            sl = host_batch_slice(n, mesh)
            slices[n] = (sl.start, sl.stop)
        except ValueError:
            slices[n] = None
        meshes[n] = auto_mesh_for_batch(n).size
    rows = host_batch_slice(len(batch['aa']), mesh)
    local = global_batch_from_host_shards(take_rows(batch, rows), 'cpu')
    back = {k: gather_rows(v, mesh) for k, v in local.items()}
    sharded = shard_batch(batch if mesh.rank == 0 else None, mesh)
    shard_ok = sorted(sharded) == sorted(local) and all(
        torch.equal(sharded[k], local[k]) for k in local)
    own = {'w': torch.full((3,), float(mesh.rank)),
           'n': torch.tensor([mesh.rank])}
    replicate(own, mesh)
    replicate_ok = bool((own['w'] == 0).all()) and int(own['n']) == 0
    torch.manual_seed(0)
    state = {'w': torch.randn(8, 4), 'b': torch.randn(4)}
    assert_replicated_params_equal(state, mesh)
    if mesh.rank == 1:
        state['b'][2] += 1e-2
    try:
        assert_replicated_params_equal(state, mesh)
        raised = False
    except AssertionError:
        raised = True
    return {'rank': mesh.rank, 'slices': slices, 'meshes': meshes,
            'gathered': back if mesh.rank == 0 else None, 'raised': raised,
            'shard_batch': shard_ok, 'replicate': replicate_ok}


JOBS = {'train': train, 'shard_mean_losses': shard_mean_losses,
        'sample': sample, 'helpers': helpers,
        'dropout_streams': dropout_streams}


def run_jobs(jobs: Sequence) -> Dict:
    """``[(name, kwargs), ...]`` -> ``{name: JOBS[name](**kwargs)}``, in
    order; a name may carry a suffix after '/' ('train/2' runs 'train')."""
    return {name: JOBS[name.split('/')[0]](**kw) for name, kw in jobs}
