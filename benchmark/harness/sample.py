"""Traffic of kind ``sample``: design requests in a closed loop.

A request is one complex of the pool fanned out into ``fan_out``
trajectories: the body of the port's ``BatchedSampler.__call__``
(``runners/design.py``) with the noise handed in through ``draws=``:
``DiffAb.sample`` (encode once, the reverse loop with the sampler's
encoder kernel), the backbone rebuilt on the device, every output copied
to the host. The next request goes out when the last one's results are
on the host.

The output check reads a sample of the finished requests (drawn from the
seed) whole. The reference computes each trajectory's first reverse step
from the initial state that the same draws give (the encode, the six
GABlock layers, the heads and the three transitions at the first level),
and the gaps to the program's state after that step are compared. At a
few later steps drawn from the seed it takes the program's kept state
before the step and the step's own draws, and compares its step with the
program's: the positions by the noise prediction that their gap implies,
the sequence by how far below the reference's best score (log posterior
plus the step's Gumbel draw) the program's token lies. Rotations and
scores past the first step are not compared: the random-weight denoiser
drives the positions hundreds of Angstrom out, where the point attention
switches keys under any rounding, and they differ as much in a sound
bfloat16 run as in the control (PERF.md). Every context residue is held
unchanged at every step, and the backbone the program rebuilt from its
last state is compared with the reference's rebuild of that state."""
from __future__ import annotations

import time

import numpy as np
import torch

from . import flops
from .traffic import (batch_rows, check_steps, request_draws, rows_of,
                      step_draws, sub_seed, to_device)
from .weights import load_state, seeded_state

WARMUP_CALL = 2 ** 32      # the warm-up request's draws (no window call)
BLOCK = 32                 # trajectories the reference computes at once


def _to_numpy(out):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in out.items()}


class SampleDriver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        self.model_cfg = dict(cell.config['model'])
        self.fan_out = int(tr['fan_out'])
        self.L = int(tr['length'])
        self.flags = dict(sample_structure=bool(tr.get('sample_structure',
                                                       True)),
                          sample_sequence=bool(tr.get('sample_sequence',
                                                      True)))
        self.sequence = self.model_cfg.get('type', 'diffab') == 'diffab'

    # ---------------------------------------------------------------- set-up

    def setup(self):
        from ab_opt_tpu_torch.models import get_model
        self.model = get_model(dict(self.model_cfg))
        self.weights = seeded_state(self.model, sub_seed(self.seed, 0),
                                    self.device,
                                    self.cell.config.get('weight_scales'))
        self.model.to(self.device)
        load_state(self.model, self.weights)
        self.model.eval()
        self.steps = self.model.cfg.num_steps
        pool = int(self.cell.traffic.get('pool', 1))
        self.pool = [to_device(batch_rows(self.cell.traffic, self.model_cfg,
                                          self.seed, i, 1), self.device)
                     for i in range(pool)]
        self.request(WARMUP_CALL)

    def request(self, call: int) -> dict:
        """One design request, as ``BatchedSampler.__call__`` runs it."""
        from ab_opt_tpu_torch.data.collate import to_device_batch
        from ab_opt_tpu_torch.geometry import (reconstruct_backbone_partially,
                                               so3vec_to_rotation)
        batch = to_device_batch(self.pool[call % len(self.pool)],
                                self.device)
        draws = request_draws(self.seed, call, self.steps, self.fan_out,
                              self.L, self.device, self.sequence)
        out = self.model.sample(batch, num_replicas=self.fan_out,
                                draws=draws, keep_traj=True, **self.flags)
        B = out['s'].shape[0]
        tile = lambda x: x.repeat_interleave(B // x.shape[0], dim=0)
        pos_new, mask_new = reconstruct_backbone_partially(
            tile(batch['pos_heavyatom']), so3vec_to_rotation(out['v']),
            out['p'], out['s'], tile(batch['chain_nb']),
            tile(batch['res_nb']), tile(batch['mask_heavyatom']),
            tile(batch['generate_flag']))
        out['pos_atom_new'] = pos_new
        out['mask_atom_new'] = mask_new
        return _to_numpy(out)

    # ---------------------------------------------------------------- window

    def window(self, seconds: float, trace_calls: int = 0):
        """Requests until ``seconds`` have passed since the first started;
        with ``trace_calls``, the profiler over that many requests from the
        second on. Returns (end-to-end metrics, attempted, failed,
        session or None)."""
        from .trace import Session
        tr = self.cell.traffic
        rng = np.random.default_rng(sub_seed(self.seed, 5))
        keep_n = int(tr['check_requests'])
        self.kept, session, i = [], None, 0
        t_first = time.perf_counter()
        t_last = t_first
        while (time.perf_counter() - t_first < seconds
               or (trace_calls and session is None)):
            if trace_calls and session is None and i >= 1:
                session = Session()
                with session:
                    for _ in range(trace_calls):
                        self._keep(rng, i, self.request(i), keep_n)
                        i += 1
            else:
                self._keep(rng, i, self.request(i), keep_n)
                i += 1
            t_last = time.perf_counter()
        self.traced = trace_calls
        rate = i * self.fan_out / (t_last - t_first)
        return {'samples_per_s': rate}, i, 0, session

    def _keep(self, rng, call, out, keep_n):
        """A uniform sample of ``keep_n`` finished requests (reservoir,
        drawn from the seed), kept whole."""
        if len(self.kept) < keep_n:
            self.kept.append((call, out))
            return
        j = rng.integers(0, call + 1)
        if j < keep_n:
            self.kept[j] = (call, out)

    def counts(self) -> dict:
        return {'steps': self.traced * self.steps}

    def flops(self) -> dict:
        per = flops.diffab_request_flops(self.model_cfg, self.fan_out,
                                         self.L, self.steps)
        layers = self.model_cfg['diffusion']['eps_net_opt']['num_layers']
        k1 = flops.bound_s(flops.gablock_flops(self.fan_out, self.L),
                           flops.gablock_bytes(self.fan_out, self.L,
                                               self.fan_out))
        return {'model': per * self.traced,
                'k1_bound_s': k1 * layers * self.steps * self.traced,
                'dtype': self.model_cfg.get('dtype', 'float32')}

    def release(self):
        """Free the program's state before the reference runs."""
        del self.model, self.pool
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ----------------------------------------------------------------- check

    def check(self, rounding=None, control=False) -> dict:
        """The numbers compared. ``control``: the reference with
        ``rounding`` (its Linear layers and attention computed in a lower
        precision, and the rebuild's inputs rounded so) takes the
        program's place."""
        from reference.models import DiffAb
        from . import reference_run as rr
        ref = rr.reference_model(DiffAb, self.model_cfg, self.weights,
                                 self.device)
        low = None
        if control:
            low = rr.reference_model(DiffAb, self.model_cfg, self.weights,
                                     self.device, rounding)
        gaps = rr.Gaps()
        for call, out in sorted(self.kept, key=lambda e: e[0]):
            self._check_request(ref, low, rounding, call, out, gaps)
        return gaps.numbers()

    @torch.no_grad()
    def _check_request(self, ref, low, rounding, call, out, gaps):
        from reference.geometry import (reconstruct_backbone_partially,
                                        so3vec_to_rotation)
        dev, N = self.device, self.fan_out
        pool = int(self.cell.traffic.get('pool', 1))
        batch = to_device(batch_rows(self.cell.traffic, self.model_cfg,
                                     self.seed, call % pool, 1), dev)
        draws = request_draws(self.seed, call, self.steps, N, self.L, dev,
                              self.sequence)
        first = step_draws(self.seed, call, 0, N, self.L, dev, self.sequence)
        later = check_steps(self.seed, call, self.steps,
                            int(self.cell.traffic.get('check_steps', 4)))
        traj = out['traj']
        flags = (self.flags['sample_structure'],
                 self.flags['sample_sequence'])
        on = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        for r0 in range(0, N, BLOCK):
            rows = torch.arange(r0, min(N, r0 + BLOCK), device=dev)
            R = len(rows)
            v, p, s, res_feat, pair_feat, mg, mr = ref.initial_state(
                batch, rows_of(draws, rows), R, **self.flags)
            gen = mr.bool() & mg
            sl = slice(r0, r0 + R)
            kept = lambda k: (on(traj['v'][k, sl]),
                              ref.normalize_position(on(traj['p'][k, sl])),
                              on(traj['s'][k, sl]))
            for k, before in [(0, (v, p, s))] + [(k, None) for k in later]:
                dk = rows_of(first if k == 0 else step_draws(
                    self.seed, call, k, N, self.L, dev, self.sequence), rows)
                before = before or kept(k - 1)
                args = (self.steps - k, res_feat, pair_feat, mg, mr, R, dk,
                        None, *flags)
                want = ref.reverse_step(*before, *args, with_posterior=True)
                got = (kept(k) if low is None
                       else low.reverse_step(*before, *args))
                if k == 0:
                    gaps.first_step(ref, got, want, gen)
                elif flags[0]:
                    gaps.later_step(got[1], want[1], gen, ref.trans_pos.sched,
                                    self.steps - k)
                if flags[1]:
                    gaps.sequence(got[2], want[5], dk['seq_gumbel'], gen)
            # The context at every step, against the initial state.
            ctx = (mr.bool() & ~mg).cpu().numpy()
            init = (v.cpu().numpy(), ref.unnormalize_position(p).cpu().numpy(),
                    s.cpu().numpy())
            for x, x0 in zip((traj['v'][:, sl], traj['p'][:, sl],
                              traj['s'][:, sl]), init):
                gaps.context(x, x0, ctx)
            # The backbone rebuilt from the program's last state.
            tile = lambda a: a.repeat_interleave(R, dim=0)

            def rebuild(v_last, p_last, s_last):
                return reconstruct_backbone_partially(
                    tile(batch['pos_heavyatom']), so3vec_to_rotation(v_last),
                    p_last, s_last, tile(batch['chain_nb']),
                    tile(batch['res_nb']), tile(batch['mask_heavyatom']),
                    tile(batch['generate_flag']))
            last = (on(out['v'][sl]), on(out['p'][sl]), on(out['s'][sl]))
            pos_ref, mask_ref = rebuild(*last)
            if low is None:
                pos_got = on(out['pos_atom_new'][sl])
                mask_got = on(out['mask_atom_new'][sl])
            else:
                pos_got, mask_got = rebuild(rounding(last[0]),
                                            rounding(last[1]), last[2])
            gaps.backbone(pos_got, mask_got.bool(), pos_ref,
                          mask_ref.bool())
