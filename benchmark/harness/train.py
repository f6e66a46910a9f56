"""Traffic of kind ``train``: optimizer steps in a closed loop.

Set-up builds the port's ``Trainer`` (the model with the benchmark's
weights, Adam, the clip), and drives it through its first three steps
with the window's own call, ``Trainer.train_step(batch, generator, t,
draws, defer_nan_check=True)``, on three different batches of the pool
(already on the card) with draws made from the seed. The window then runs
the same call on the pool's batches until ``--seconds`` have passed. Once
it has closed, the same object takes three more steps through the same
call, from the state the window left.

The output check reads both stretches of three steps: each step's
weighted loss, the first gradient as Adam got it (worked out from its
first moment before and after the step) and the parameters' change over
the three. The reference follows the first stretch from the benchmark's
own weights, and the second from the program's state at its start (its
parameters and Adam's moments and step count): the only way to follow
the window's path, whose own start is checked by the first.

The graph model draws its dropout masks itself, from the trainer's loss
generator of each step (``Trainer.loss_generator``: seeded from the
generator's seed, the iteration, the rank and the stream); the reference
draws them from a generator seeded so, in its layers' order."""
from __future__ import annotations

import time

import numpy as np
import torch

from . import flops
from .traffic import batch_rows, loss_draws, sub_seed, to_device
from .weights import load_state, seeded_state

CHECKED = 3            # the steps the output check follows


class TrainDriver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        self.model_cfg = dict(cell.config['model'])
        self.train_cfg = dict(cell.config['train'])
        self.N, self.L = int(tr['batch']), int(tr['length'])
        self.gnn = self.model_cfg.get('type') == 'diff_gnn'
        self.sequence = (not self.gnn
                         and self.model_cfg.get('train_sequence', True))

    def _batch(self, i: int) -> dict:
        return to_device(batch_rows(self.cell.traffic, self.model_cfg,
                                    self.seed, i, self.N), self.device)

    def _draws(self, k: int):
        return loss_draws(self.seed, k, self.N, self.L, self.num_steps,
                          self.device, self.sequence)

    # ---------------------------------------------------------------- set-up

    def setup(self):
        from ab_opt_tpu_torch.models import get_model
        from ab_opt_tpu_torch.train.trainer import Trainer
        model = get_model(dict(self.model_cfg))
        self.weights = seeded_state(model, sub_seed(self.seed, 0),
                                    self.device,
                                    self.cell.config.get('weight_scales'))
        model.to(self.device)
        load_state(model, self.weights)
        self.num_steps = model.cfg.num_steps
        self.trainer = Trainer(model, self.train_cfg, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, 6))
        self.pool_n = max(int(self.cell.traffic.get('pool', CHECKED)),
                          CHECKED)
        self.pool = [self._batch(i) for i in range(self.pool_n)]
        self.segments = [self._checked(0)]
        if self.device != 'cpu' and torch.cuda.is_available():
            torch.cuda.synchronize()

    def _checked(self, k0: int) -> dict:
        """Steps k0 .. k0 + 2 through the window's call, and what the check
        reads of them: the state they start from (parameters, Adam's
        moments and step count), each step's loss, the norm a leaf of the
        first step's gradient as Adam got it, and of the change."""
        opt = self.trainer.optimizer
        params = dict(self.trainer.model.named_parameters())
        self.trainer.flush_nan_checks()
        start = {'k0': k0, 'params': {}, 'm': {}, 'v': {}, 'step': {}}
        for n, p in params.items():
            st = opt.state.get(p, {})
            start['params'][n] = p.detach().clone()
            start['m'][n] = (st['exp_avg'].clone() if 'exp_avg' in st
                             else torch.zeros_like(p))
            start['v'][n] = (st['exp_avg_sq'].clone() if 'exp_avg_sq' in st
                             else torch.zeros_like(p))
            start['step'][n] = float(st.get('step', 0))
        b1 = float(self.train_cfg['optimizer'].get('beta1', 0.9))
        first = {}
        for k in range(k0, k0 + CHECKED):
            self.step(k)
            if k == k0:
                self.trainer.flush_nan_checks()
                for n, p in params.items():
                    m1 = opt.state[p]['exp_avg'] if p in opt.state else None
                    first[n] = (0.0 if m1 is None else float(
                        (m1 - b1 * start['m'][n]).norm()) / (1.0 - b1))
        self.trainer.flush_nan_checks()
        changed = {n: float((p.detach() - start['params'][n]).norm())
                   for n, p in params.items()}
        losses = list(self.trainer.loss_history['overall'])[k0:k0 + CHECKED]
        return dict(start=start, losses=losses, first=first,
                    changed=changed)

    def step(self, k: int):
        t, d = self._draws(k)
        return self.trainer.train_step(self.pool[k % self.pool_n],
                                       generator=self.generator, t=t,
                                       draws=d, defer_nan_check=True)

    # ---------------------------------------------------------------- window

    def window(self, seconds: float, trace_calls: int = 0):
        """Steps until ``seconds`` have passed since the first started,
        then one synchronisation; with ``trace_calls``, the profiler over
        that many steps from the second on."""
        from .trace import Session
        session, k0 = None, CHECKED
        k = k0
        t_first = time.perf_counter()
        while (time.perf_counter() - t_first < seconds
               or (trace_calls and session is None)):
            if trace_calls and session is None and k > k0:
                session = Session()
                with session:
                    for _ in range(trace_calls):
                        self.step(k)
                        k += 1
                    self.trainer.flush_nan_checks()
            else:
                self.step(k)
                k += 1
        self.trainer.flush_nan_checks()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t_last = time.perf_counter()
        self.traced = trace_calls
        rate = (k - k0) * self.N / (t_last - t_first)
        self.segments.append(self._checked(k))
        return {'train_samples_per_s': rate}, k - k0, 0, session

    def counts(self) -> dict:
        return {'steps': self.traced}

    def flops(self) -> dict:
        dtype = self.model_cfg.get('dtype', 'float32')
        out = {'dtype': dtype}
        if self.gnn:
            ctx, inter = self._edges()
            per = flops.gnn_train_flops(self.model_cfg, self.N, self.L, ctx,
                                        inter)
        else:
            per = flops.diffab_train_flops(self.model_cfg, self.N, self.L)
            layers = self.model_cfg['diffusion']['eps_net_opt']['num_layers']
            f, b = flops.attention_fwd(self.N, self.L)
            fb, bb = flops.attention_bwd(self.N, self.L)
            out['k2k3_bound_s'] = layers * self.traced * (
                flops.bound_s(f, b) + flops.bound_s(fb, bb))
        out['model'] = per * self.traced
        return out

    def _edges(self):
        """The pool's mean ctx and inter edge counts a batch (the graph
        model's adjacency, from the reference's own functions)."""
        from reference.constants import BBHeavyAtom
        from reference.models.diff_gnn import interpolate_masked_coords
        from reference.nn.egnn import build_adjacency
        cfg = self.model_cfg
        ctx = inter = 0
        for b in self.pool:
            coord = b['pos_heavyatom'][:, :, :cfg['num_atoms']].float()
            mc = interpolate_masked_coords(coord, b['generate_flag'],
                                           b['mask'])
            c, i = build_adjacency(mc[:, :, BBHeavyAtom.CA],
                                   b['fragment_type'], b['mask'],
                                   cfg.get('ctx_cutoff', 8.0),
                                   cfg.get('inter_cutoff', 12.0))
            ctx += int(c.sum())
            inter += int(i.sum())
        return ctx / len(self.pool), inter / len(self.pool)

    def release(self):
        del self.trainer, self.pool
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ----------------------------------------------------------------- check

    def check(self, rounding=None, control=False, tf32=False) -> dict:
        """The numbers compared, of the set-up's steps and (``window_``)
        of the steps after the window. ``control``: the reference computed
        in a lower precision (``rounding`` of its Linear operands, or
        TF32) takes the program's place."""
        from reference.models import DiffAb, DiffGNN
        from . import reference_run as rr
        cls = DiffGNN if self.gnn else DiffAb
        prev = torch.backends.cuda.matmul.allow_tf32
        numbers = {}
        for prefix, seg in zip(('', 'window_'), self.segments):
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            ref = self._reference(rr, cls, seg, None)
            if control:
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
                got = self._reference(rr, cls, seg, rounding)
            else:
                got = (seg['losses'], seg['first'], seg['changed'])
            losses, first, change = ref
            med = float(np.median(list(first.values())))
            moved = {n for n, g in first.items() if g >= 1e-3 * med}
            changes = rr.leaf_gaps(got[2], change, moved)
            numbers.update({
                prefix + 'loss_gap': max(abs(a - b) / max(abs(b), 1e-30)
                                         for a, b in zip(got[0], losses)),
                prefix + 'grad_gap': float(rr.leaf_gaps(got[1], first).max()),
                prefix + 'change_gap': float(changes.max()),
                prefix + 'change_gap_median': float(np.median(changes))})
        torch.backends.cuda.matmul.allow_tf32 = prev
        torch.backends.cudnn.allow_tf32 = prev
        return numbers

    def _reference(self, rr, cls, seg, rounding):
        """The reference's three steps of a checked stretch ``seg``: from
        the benchmark's weights for the first, from the program's state at
        its start for the one after the window."""
        start = seg['start']
        k0 = start['k0']
        weights = self.weights if k0 == 0 else start['params']
        model = rr.reference_model(cls, self.model_cfg, weights,
                                   self.device, rounding)
        ks = range(k0, k0 + CHECKED)
        batches = [self._batch(k % self.pool_n) for k in ks]
        draws = [self._draws(k) for k in ks]
        root = self.generator.initial_seed()
        gens = [torch.Generator(device=self.device).manual_seed(int(
            np.random.SeedSequence([root, k, 0, 0]).generate_state(1)[0]))
            for k in ks]
        out = rr.train_reference(
            model, batches, draws, gens, self.train_cfg['loss_weights'],
            float(self.train_cfg.get('max_grad_norm', 100.0)),
            self.train_cfg['optimizer'],
            moments=None if k0 == 0 else (start['m'], start['v'],
                                          start['step']))
        del model
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out
