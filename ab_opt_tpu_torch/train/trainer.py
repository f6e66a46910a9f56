"""Training loop (counterpart of ``ab_opt_tpu/train/trainer.py``), its step
built on ``parallel/mesh.py::sharded_train_step`` as JAX's is:

* the weighted multi-loss objective over the weighted keys only, gradients
  clipped to a global norm (``scale = min(1, max / (norm + 1e-6))``), Adam;
* validation every ``val_freq`` iterations feeding a plateau LR scheduler;
* a finite-loss guard that dumps the offending batch and raises;
* checkpoints that carry the config and resume with the optimizer state.

Under a process group (``n_devices`` ranks, ``parallel/launch.py``) each
rank trains on its rows of the global batch and the step sums the
gradients over the ranks: the losses, gradients and parameters are the
one-device run's on the same global batch, since every rank draws the
global batch's ``t`` and noise from one generator (seeded alike on every
rank) and keeps its rows. The draws a loss makes itself (the graph
model's dropout masks) come from a generator of each rank's own
(:meth:`Trainer.loss_generator`), so every row gets masks of its own as
on one device, and only the masks differ from a one-device run.
Validation is reduced over the ranks, the finite-loss flag too (so every
rank raises together), and rank 0 alone writes checkpoints and runs the
sampling eval while the others wait.

The trainer runs on the CUDA card unless the caller asks for the CPU; the
model's IPA attention then runs through the K2/K3 kernels, and the
sampling-in-the-loop validation (:mod:`.sampling_eval`) through the
sampler's encoder kernel (K1, or K4 past 256 residues). On the card, on
one rank, with a model whose loss draws nothing of its own given ``t`` and
the draws (DiffAb; not the graph model while its dropout is on), each step
replays a CUDA graph of the whole step, captured at a batch shape's second
step (:mod:`.step_graph`); Adam is then capturable and reads its learning
rate from a device tensor. Elsewhere the step is eager.
"""
from __future__ import annotations

import array
import logging
import os
import pickle
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.collate import to_device_batch
from ..parallel.distributed import (global_batch_sums,
                                    host_batch_slice, take_rows)
from ..parallel.mesh import (auto_mesh_for_batch, replicate,
                             sharded_train_step, weighted_total)
from ..utils.device import resolve_device
from ..utils.profiling import span
from .checkpoint import (load_checkpoint, read_weights, require_resumable,
                         save_checkpoint)
from .step_graph import TrainGraphs, graphable

logger = logging.getLogger(__name__)

# The DiffAb train step the JAX package times (bench.py:117-152) with the
# optimizer and scheduler of configs/train/codesign_single.yml.
DIFFAB_TRAIN_CONFIG = {
    'batch_size': 16,
    'loss_weights': {'rot': 1.0, 'pos': 1.0, 'seq': 1.0, 'dist': 1.0,
                     'prmsd': 0.1},
    'max_grad_norm': 100.0,
    'optimizer': {'type': 'adam', 'lr': 1e-4, 'weight_decay': 0.0,
                  'beta1': 0.9, 'beta2': 0.999},
    'scheduler': {'type': 'plateau', 'factor': 0.8, 'patience': 10,
                  'min_lr': 5e-6},
    'max_iters': 200_000,
    'val_freq': 1000,
}


def build_optimizer(params, cfg: Dict) -> torch.optim.Optimizer:
    """Adam (AdamW when weight_decay > 0), eps 1e-8 as optax's."""
    typ = cfg.get('type', 'adam')
    if typ != 'adam':
        raise ValueError(f'Unknown optimizer type {typ}')
    kw = dict(lr=float(cfg.get('lr', 1e-4)), eps=1e-8,
              betas=(float(cfg.get('beta1', 0.9)),
                     float(cfg.get('beta2', 0.999))))
    wd = float(cfg.get('weight_decay', 0.0))
    if wd > 0:
        return torch.optim.AdamW(params, weight_decay=wd, **kw)
    return torch.optim.Adam(params, **kw)


class PlateauScheduler:
    """ReduceLROnPlateau (factor / patience / min_lr)."""

    def __init__(self, factor=0.8, patience=10, min_lr=5e-6, **_):
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_lr = float(min_lr)
        self.best = float('inf')
        self.bad_epochs = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best - 1e-8:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                return max(self.min_lr, lr * self.factor)
        return lr


class ExpScheduler:
    def __init__(self, factor=0.98, min_lr=1e-6, **_):
        self.factor, self.min_lr = float(factor), float(min_lr)

    def step(self, metric, lr):
        return max(self.min_lr, lr * self.factor)


def build_scheduler(cfg: Optional[Dict]):
    if not cfg:
        return None
    typ = cfg.get('type', 'plateau')
    opts = {k: v for k, v in cfg.items() if k != 'type'}
    if typ == 'plateau':
        return PlateauScheduler(**opts)
    if typ == 'exp':
        return ExpScheduler(**opts)
    raise ValueError(f'Unknown scheduler type {typ}')


class Trainer:
    """``device=None`` trains on the CUDA card (and raises without one);
    pass ``device='cpu'`` to train on the CPU. The model is moved there.

    ``n_devices``: the ranks to train over (the largest count up to it that
    divides the config's ``batch_size``; default every rank of the process
    group, one without a group). Each rank then passes its rows of the
    global batch to :meth:`train_step`.

    ``graph=False`` keeps every step eager where the step would replay a
    CUDA graph (for a side-by-side check of the graphs; Adam keeps the
    graphed route's capturable form)."""

    def __init__(self, model, train_cfg: Dict, log_dir: Optional[str] = None,
                 full_config: Optional[Dict] = None, device=None,
                 n_devices: Optional[int] = None, graph: bool = True):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = dict(train_cfg)
        self.full_config = full_config or {}
        self.mesh = auto_mesh_for_batch(int(train_cfg.get('batch_size', 1)),
                                        n_devices)
        if self.mesh.rank < 0:
            raise ValueError(
                f'batch {train_cfg.get("batch_size")} trains on the first '
                f'{self.mesh.size} ranks only; start {self.mesh.size}')
        self.is_main = self.mesh.rank == 0
        replicate(self.model, self.mesh)
        self.log_dir = log_dir
        self.ckpt_dir = os.path.join(log_dir, 'checkpoints') if log_dir else None
        if self.ckpt_dir and self.is_main:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        opt_cfg = train_cfg.get('optimizer', {})
        self.optimizer = build_optimizer(self.model.parameters(), opt_cfg)
        self.scheduler = build_scheduler(train_cfg.get('scheduler'))
        self.loss_weights = dict(train_cfg.get('loss_weights', {}))
        self.max_grad_norm = float(train_cfg.get('max_grad_norm', 100.0))
        self.lr = float(opt_cfg.get('lr', 1e-4))
        # On the graphed route the learning rate lives on the card, where
        # a replayed Adam reads it; _set_lr writes it in place.
        capturable = graphable(self.model, self.device, self.mesh)
        self._lr_cell = (torch.tensor(self.lr, device=self.device)
                         if capturable else None)
        self._fit_optimizer_state()
        self._set_lr(self.lr)
        self.step_fn = sharded_train_step(
            self.model, self.optimizer, self.mesh,
            loss_weights=self.loss_weights, max_grad_norm=self.max_grad_norm)
        self.graphs = (TrainGraphs(self.step_fn, self.model, self.optimizer,
                                   self.device)
                       if capturable and graph else None)
        self.iteration = 0
        self._pending_checks = deque()
        # The global losses of every step this trainer took (key -> one
        # value a step), read one step late with the finite flag, and the
        # average val loss of every validation by iteration.
        self.loss_history: Dict[str, array.array] = {}
        self.val_history: Dict[int, float] = {}

    # ------------------------------------------------------------ checkpoints

    def save(self, extra: Optional[Dict] = None) -> Optional[str]:
        """Rank 0 writes the checkpoint (the module's own state dict, which
        resumes at any rank count); other ranks write nothing."""
        if not (self.ckpt_dir and self.is_main):
            return None
        path = os.path.join(self.ckpt_dir, f'{self.iteration}.ckpt')
        return save_checkpoint(
            path, config=self.full_config, model=self.model.state_dict(),
            optimizer=self.optimizer.state_dict(), iteration=self.iteration,
            extra=dict(extra or {}, lr=self.lr))

    def resume(self, ckpt_path: str, finetune: bool = False):
        """Restore the weights; unless ``finetune``, also the optimizer
        state, the iteration and the learning rate. ``finetune`` also takes
        a JAX checkpoint (its params through the weight bridge); resuming
        one raises, since its optax state has no counterpart here."""
        if finetune:
            self.model.load_state_dict(read_weights(ckpt_path)['state_dict'])
        else:
            require_resumable(ckpt_path)
            saved = load_checkpoint(ckpt_path)
            self.model.load_state_dict(saved['model'])
            if saved.get('optimizer') is not None:
                self.optimizer.load_state_dict(saved['optimizer'])
                self._fit_optimizer_state()
            self.iteration = int(saved.get('iteration', 0))
            self._set_lr(float(saved.get('extra', {}).get('lr', self.lr)))
        logger.info('Restored checkpoint %s at iteration %d', ckpt_path,
                    self.iteration)

    # ------------------------------------------------------------------ steps

    def _set_lr(self, lr: float):
        self.lr = lr
        if self._lr_cell is not None:
            self._lr_cell.fill_(lr)
        for group in self.optimizer.param_groups:
            group['lr'] = lr if self._lr_cell is None else self._lr_cell

    def _fit_optimizer_state(self):
        """Adam in this trainer's form, when built and after a checkpoint
        (which either route may have written): capturable with the step
        counts on the card on the graphed route, plain with them on the
        host otherwise; :meth:`_set_lr` then puts the learning rate in
        (a device tensor or a float)."""
        capturable = self._lr_cell is not None
        for group in self.optimizer.param_groups:
            group['capturable'] = capturable
        home = self.device if capturable else torch.device('cpu')
        for state in self.optimizer.state.values():
            if 'step' in state:
                state['step'] = state['step'].to(home, torch.float32)

    def _weighted_total(self, losses: Dict) -> torch.Tensor:
        return weighted_total(losses, self.loss_weights)

    def rank_draws(self, batch: Dict, generator=None):
        """(t, draws) for this rank's rows ``batch``: drawn for the global
        batch (the rows of every rank) from ``generator`` and cut to this
        rank's rows, so the numbers do not depend on the rank count."""
        N, L = batch['aa'].shape
        n = N * self.mesh.size
        t, draws = self.model.loss_draws(n, L, generator, self.device)
        rows = host_batch_slice(n, self.mesh)
        return t[rows], take_rows(draws, rows)

    def loss_generator(self, generator, stream: int = 0):
        """This rank's own generator for the draws a loss makes itself (the
        graph model's dropout masks) at this iteration: seeded from
        ``generator``'s seed, the iteration, the rank and ``stream`` (0 the
        train step, 1 validation). Every rank's rows then get masks of
        their own, as one device draws every row's, and ``generator``,
        which draws the global batch's ``t`` and noise, advances alike on
        every rank. None for None."""
        if generator is None:
            return None
        seed = np.random.SeedSequence(
            [generator.initial_seed(), self.iteration, self.mesh.rank,
             stream]).generate_state(1)[0]
        return torch.Generator(device=generator.device).manual_seed(int(seed))

    def loss_and_grads(self, batch: Dict, generator=None, t=None, draws=None,
                       attention=None) -> Dict:
        """The losses of one device batch, with the gradients of their
        weighted total left in the parameters' ``.grad`` (unclipped); the
        draws the loss makes itself come from :meth:`loss_generator`, as
        in :meth:`train_step`. Returns the loss dict, detached, with
        'overall' added."""
        self.optimizer.zero_grad(set_to_none=True)
        # ``attention`` is DiffAb's encoder hook; the graph model has none,
        # and its loss refuses the keyword.
        kw = {} if attention is None else {'attention': attention}
        losses = self.model.loss(batch, generator=self.loss_generator(
            generator), t=t, draws=draws, **kw)
        total = self._weighted_total(losses)
        total.backward()
        return dict({k: v.detach() for k, v in losses.items()},
                    overall=total.detach())

    def train_step(self, batch: Dict, generator=None, t=None, draws=None,
                   defer_nan_check: bool = False) -> Dict:
        """One optimizer step on ``batch`` (numpy or tensors; this rank's
        rows of the global batch). ``t`` and ``draws`` are this rank's rows
        (default :meth:`rank_draws` from ``generator``); the loss's own
        draws come from :meth:`loss_generator`. Returns the global loss
        dict as device scalars. The finite check is one device flag,
        reduced over the ranks; with ``defer_nan_check`` the host reads it
        one step late, so it never waits for the step it just queued.

        On the graphed route (:mod:`.step_graph`) a step with its ``t`` and
        draws replays the batch shape's graph; the ``train.step`` span's
        ``graph`` says 'eager', 'capture' or 'replay'."""
        with span('train.step', request=self.iteration) as tags:
            dev_batch = to_device_batch(batch, self.device)
            if t is None and draws is None:
                t, draws = self.rank_draws(dev_batch, generator)
            if self.graphs is not None and t is not None and draws is not None:
                losses, mode = self.graphs.step(dev_batch, t, draws)
            else:
                losses, mode = self.step_fn(
                    dev_batch, generator=self.loss_generator(generator),
                    t=t, draws=draws), 'eager'
            if tags is not None:
                tags['graph'] = mode
            finite = losses.pop('_finite')
            self._pending_checks.append((self.iteration, finite, batch,
                                         losses))
            if defer_nan_check:
                while len(self._pending_checks) > 1:
                    self._check_oldest()
            else:
                self.flush_nan_checks()
            self.iteration += 1
            return losses

    def _check_oldest(self):
        it, finite, batch, losses = self._pending_checks.popleft()
        # One read of the flag and the losses together.
        ok, *values = torch.stack([finite.float(), *losses.values()]).tolist()
        if not ok:
            losses = dict(zip(losses, values))
            self._dump_nan_state(batch, losses, it)
            raise FloatingPointError(f'Non-finite loss at it {it}: {losses}')
        for k, v in zip(losses, values):
            self.loss_history.setdefault(k, array.array('d')).append(v)

    def flush_nan_checks(self):
        while self._pending_checks:
            self._check_oldest()

    def _dump_nan_state(self, batch, losses, iteration):
        """Persist the offending batch (this rank's rows) and losses next to
        the logs."""
        if not self.log_dir:
            return
        rank = '' if self.is_main else f'_rank{self.mesh.rank}'
        path = os.path.join(self.log_dir, f'nan_dump_it{iteration}{rank}.pkl')
        as_np = lambda v: v.detach().cpu().numpy() if torch.is_tensor(v) else v
        with open(path, 'wb') as f:
            pickle.dump({'batch': {k: as_np(v) for k, v in batch.items()},
                         'losses': losses, 'iteration': iteration}, f)
        logger.error('Non-finite loss; dumped state to %s', path)

    @torch.no_grad()
    def validate(self, val_loader: Iterable, generator=None) -> float:
        """Average weighted validation loss over the global val batches
        (every rank reads them whole); feeds the scheduler. Each batch's
        draws are the global batch's. Under a process group each rank
        computes its rows of a batch whose size divides over the ranks, and
        rank 0 alone a batch that does not; one all-reduce then gives every
        rank the same losses, and the same learning rate. The loss's own
        draws (dropout masks) come from this rank's
        :meth:`loss_generator`, so ``generator`` advances alike on every
        rank even where rank 0 computes a batch alone."""
        mesh, tape = self.mesh, []
        own = self.loss_generator(generator, stream=1)
        for b in val_loader:
            b = to_device_batch(b, self.device)
            N, L = b['aa'].shape
            t, draws = self.model.loss_draws(N, L, generator, self.device)
            if N % mesh.size == 0:
                rows = host_batch_slice(N, mesh)
                with global_batch_sums(mesh):
                    losses = self.model.loss(
                        take_rows(b, rows), generator=own, t=t[rows],
                        draws=take_rows(draws, rows))
            elif self.is_main:
                losses = self.model.loss(b, generator=own, t=t, draws=draws)
            else:
                tape.append(torch.zeros((), device=self.device))
                continue
            tape.append(self._weighted_total(losses).float())
        tape = mesh.all_reduce_(torch.stack(tape)) if tape else None
        avg = float(tape.mean()) if tape is not None else float('nan')
        if self.scheduler is not None and np.isfinite(avg):
            new_lr = self.scheduler.step(avg, self.lr)
            if new_lr != self.lr:
                logger.info('Plateau: lr %.3g -> %.3g', self.lr, new_lr)
                self._set_lr(new_lr)
        return avg

    def _sampling_eval(self, items, num_samples, seed, tracker) -> Dict:
        """Design the val items, log per-CDR RMSD/AAR, update the best
        checkpoint."""
        from .sampling_eval import evaluate_samples
        out_dir = (os.path.join(self.log_dir, 'sampling_eval',
                                f'it{self.iteration}')
                   if self.log_dir else None)
        metrics = evaluate_samples(self.model, items, seed,
                                   num_samples=num_samples, out_dir=out_dir,
                                   device=self.device)
        logger.info('sampling eval it %d | %s', self.iteration,
                    ' '.join(f'{k}={v:.4f}' for k, v in metrics.items()
                             if isinstance(v, float) and np.isfinite(v)))
        # Rank by H_CDR3 RMSD like the reference; global RMSD otherwise.
        rank = metrics.get('rmsd/H_CDR3', metrics.get('rmsd', float('nan')))
        tracker.update(rank, lambda path: save_checkpoint(
            path, config=self.full_config, model=self.model.state_dict(),
            optimizer=None, iteration=self.iteration,
            extra={'sampling_eval': metrics, 'lr': self.lr}),
            self.iteration)
        return metrics

    # ------------------------------------------------------------------- loop

    def train(self, train_iterator, val_loader=None,
              max_iters: Optional[int] = None, seed: int = 0,
              log_every: int = 50,
              on_step: Optional[Callable[[int, Dict], None]] = None,
              sampling_eval_items: Optional[list] = None,
              sampling_eval_samples: int = 1):
        """Train until ``max_iters`` (default the config's): log every
        ``log_every`` iterations, validate and save every ``val_freq``
        (with a ``val_loader``), save at the end otherwise. The next batch
        is fetched and put on the device before each step is queued.
        ``on_step(iteration, losses)`` runs after every step.

        ``sampling_eval_items``: transformed val structures for
        sampling-in-the-loop validation: every val period, design them
        (``sampling_eval_samples`` samples each) and keep the best
        checkpoint by CDR-H3 CA-RMSD (the global RMSD when no H3 items
        exist); per-CDR metrics and sample PDBs land under
        ``<log_dir>/sampling_eval/it<iteration>/``. Under a process group
        ``train_iterator`` yields this rank's rows of each global batch;
        rank 0 alone saves and runs the sampling eval, the other ranks wait
        for it at a barrier."""
        max_iters = max_iters or int(self.cfg.get('max_iters', 1000))
        val_freq = int(self.cfg.get('val_freq', 1000))
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed + 1)

        best_tracker = None
        if sampling_eval_items and self.is_main:
            from .sampling_eval import BestCheckpointTracker
            best_tracker = BestCheckpointTracker(
                self.ckpt_dir or (self.log_dir or '.'), metric='rmsd')

        fetch = lambda: to_device_batch(next(train_iterator), self.device)
        batch = fetch() if self.iteration < max_iters else None
        t_last = time.time()
        while self.iteration < max_iters:
            step_batch = batch
            if self.iteration + 1 < max_iters:
                batch = fetch()
            losses = self.train_step(step_batch, generator,
                                     defer_nan_check=True)
            if on_step is not None:
                on_step(self.iteration, losses)
            if self.iteration % log_every == 0:
                dt, t_last = time.time() - t_last, time.time()
                logger.info('it %d | %s | lr %.2e | %.2f s/%d it',
                            self.iteration,
                            ' '.join(f'{k}={float(v):.4f}'
                                     for k, v in losses.items()),
                            self.lr, dt, log_every)
            if val_loader is not None and self.iteration % val_freq == 0:
                self.flush_nan_checks()
                avg = self.validate(val_loader, generator)
                logger.info('val it %d | loss %.4f', self.iteration, avg)
                self.val_history[self.iteration] = avg
                self.save(extra={'avg_val_loss': avg})
                if best_tracker is not None:
                    # Each eval's sampler seed: the run's seed and the
                    # iteration (as JAX folds the iteration into its key).
                    self._sampling_eval(sampling_eval_items,
                                        sampling_eval_samples,
                                        seed + 2 + self.iteration,
                                        best_tracker)
                self.mesh.barrier()
        self.flush_nan_checks()
        if val_loader is None:
            self.save()
            self.mesh.barrier()
        return self.model
