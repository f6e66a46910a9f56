"""Readings that set the limits of a cell's output check, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,... \
        [--controls 3] [--faults 3] [--seconds s]

For each seed a short run of the cell (set-up, ``--seconds`` of its
window, the program's state freed) and the numbers of its output check
against the plain reference: the sound readings. On the first
``--controls`` seeds also the control's: the reference in the precision
below the configuration's (float8 e4m3 operands for bfloat16, TF32 for
float32) in the program's place. On the first ``--faults`` seeds also
each fault planted in the program (:data:`FAULTS`). One JSON line a
reading on standard output."""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def half_batch(driver_cls):
    """``driver_cls`` whose steps train on the first half of each batch."""
    class HalfBatch(driver_cls):
        def step(self, k):
            t, d = self._draws(k)
            h = self.N // 2
            batch = {n: v[:h] for n, v in self.pool[k % self.pool_n]
                     .items()}
            return self.trainer.train_step(
                batch, generator=self.generator, t=t[:h],
                draws={n: v[:h] for n, v in d.items()}, defer_nan_check=True)
    return HalfBatch


def sample_fault(name: str, setattr) -> None:
    """Plant fault ``name`` in the port's reverse step, with ``setattr``
    (``monkeypatch.setattr`` or :func:`planted`'s), on every step after
    the first: 'wrong_t' steps from level t - 1 (down to 1), 'stale_draws'
    takes the previous step's draws, 'late_token' alters the first
    generated token of every trajectory."""
    import torch
    from ab_opt_tpu_torch.models.diffab import DiffAb
    real = DiffAb.reverse_step
    last = {}

    def step(self, v, p, s, t, *a, **k):
        # a: res_feat, pair_feat, mask_generate, mask_res, denoiser, reps,
        # draws, ... as the reverse loop passes them.
        a = list(a)
        later = t < self.cfg.num_steps
        if name == 'wrong_t' and later:
            t = max(t - 1, 1)
        if name == 'stale_draws':
            here = a[6]
            if later and 'draws' in last:
                a[6] = last['draws']
            last['draws'] = here
        out = real(self, v, p, s, t, *a, **k)
        if name == 'late_token' and later:
            tok = out[2].clone()
            rows = torch.arange(tok.shape[0], device=tok.device)
            first = a[2].float().argmax(-1)
            tok[rows, first] = (tok[rows, first] + 1) % 20
            out = (out[0], out[1], tok) + tuple(out[3:])
        return out
    setattr(DiffAb, 'reverse_step', step)


FAULTS = {'sample': ['wrong_t', 'stale_draws', 'late_token'],
          'train': ['half_batch']}


@contextlib.contextmanager
def planted(kind: str, fault: str, cls):
    """The driver class of a run with ``fault`` planted (None: sound)."""
    undo = []

    def put(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        if fault == 'half_batch':
            cls = half_batch(cls)
        elif fault is not None:
            sample_fault(fault, put)
        yield cls
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)


def reading(driver, seconds, **check):
    import torch
    driver.setup()
    driver.window(seconds)
    driver.release()
    out = driver.check(**check)
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--controls', type=int, default=3)
    ap.add_argument('--faults', type=int, default=3)
    ap.add_argument('--seconds', type=float, default=1.0)
    args = ap.parse_args()
    import torch
    from harness import guard, manifest, reference_run, run_cell
    cell = manifest.load_cell(args.workload)
    guard.require_cards(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = cell.traffic['kind']
    cls = run_cell.DRIVERS[kind]
    bf16 = cell.config['model'].get('dtype') == 'bfloat16'
    control = (dict(rounding=reference_run.round_fp8) if bf16
               else dict(tf32=True))
    if kind == 'sample':
        control.pop('tf32', None)
    seeds = [int(s) for s in args.seeds.split(',')]
    for i, seed in enumerate(seeds):
        runs = [('sound', None, {})]
        if i < args.controls:
            runs.append(('control', None, dict(control, control=True)))
        if i < args.faults:
            runs += [(f, f, {}) for f in FAULTS[kind]]
        for name, fault, kw in runs:
            t0 = time.perf_counter()
            with planted(kind, fault, cls) as c:
                numbers = reading(c(cell, seed, 'cuda'), args.seconds, **kw)
            print(json.dumps({'cell': cell.name, 'seed': seed, 'kind': name,
                              'numbers': numbers,
                              's': time.perf_counter() - t0}), flush=True)


if __name__ == '__main__':
    main()
