"""The output check on tiny cells on the CPU: the port's plain path
agrees with the reference; the control (the reference in float8 operands
in the program's place) and each fault planted in the program read as
not correct. The run is the harness's own, past its look for a card."""
import time

import pytest
import torch

import bench_tiny
from harness import reference_run, run_cell
from calibrate import half_batch, sample_fault

SEED = 2 ** 31 + 977
CELLS = [('sample', 'diffab'), ('train', 'diffab'), ('train', 'gnn')]


def _run(cell):
    return run_cell.run(cell, SEED, 0.2, False, 'cpu', time.perf_counter())


@pytest.mark.parametrize('kind,model', CELLS)
def test_port_agrees_with_reference(kind, model):
    r = _run(bench_tiny.cell(kind, model))
    assert r['correct'], r['checks']
    assert list(r)[-1] == 'checks'
    assert r['build_s'] == 0.0      # the tiny cells name no kernel source


@pytest.mark.parametrize('kind,model', CELLS)
def test_control_fails(kind, model):
    cell = bench_tiny.cell(kind, model)
    driver = run_cell.DRIVERS[kind](cell, SEED, 'cpu')
    driver.setup()
    driver.window(0.2)
    driver.release()
    sound = driver.check()
    low = driver.check(rounding=reference_run.round_fp8, control=True)
    ok, _ = run_cell.judge(low, cell.limits)
    assert not ok, low
    assert any(low[n] >= 3 * max(sound[n], 1e-12) for n in low), (sound, low)


def _fault_sample_unchanged(monkeypatch):
    from ab_opt_tpu_torch.models.diffab import DiffAb
    real = DiffAb.reverse_step

    def step(self, v, p, s, *a, **k):
        out = real(self, v, p, s, *a, **k)
        return (v, p, s) + tuple(out[3:])
    monkeypatch.setattr(DiffAb, 'reverse_step', step)


def _fault_sample_half(monkeypatch):
    from ab_opt_tpu_torch.models.diffab import DiffAb
    real = DiffAb.sample

    def sample(self, batch, num_replicas=1, draws=None, **k):
        h = num_replicas // 2
        n_rows = h * batch['aa'].shape[0]
        half = {n: v[:n_rows] for n, v in draws.items() if torch.is_tensor(v)}
        half['steps'] = [{n: v[:n_rows] for n, v in d.items()}
                         for d in (draws['steps'][k]
                                   for k in range(len(draws['steps'])))]
        out = real(self, batch, num_replicas=h, draws=half, **k)
        twice = lambda x, ax: torch.cat([x, x], ax)
        return {n: ({m: twice(w, 1) for m, w in x.items()} if n == 'traj'
                    else twice(x, 1 if n in ('prmsd', 'perplexity') else 0))
                for n, x in out.items()}
    monkeypatch.setattr(DiffAb, 'sample', sample)


def _fault_sample_token(monkeypatch):
    from ab_opt_tpu_torch.diffusion.transitions import SequenceTransition
    real = SequenceTransition.denoise

    def denoise(self, x_t, c, mask, t, **k):
        post, s = real(self, x_t, c, mask, t, **k)
        first = mask.float().argmax(-1)
        rows = torch.arange(s.shape[0])
        s = s.clone()
        s[rows, first] = (s[rows, first] + 1) % 20
        return post, s
    monkeypatch.setattr(SequenceTransition, 'denoise', denoise)


def _fault_train_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, 'step', lambda self, *a, **k: None)


def _fault_train_late(monkeypatch):
    """Adam leaves the state unchanged once set-up's steps are done: only
    the steps after the window can show it."""
    real, calls = torch.optim.Adam.step, []

    def step(self, *a, **k):
        calls.append(1)
        if len(calls) <= 3:
            return real(self, *a, **k)
    monkeypatch.setattr(torch.optim.Adam, 'step', step)


def _fault_train_answer(monkeypatch, model):
    from ab_opt_tpu_torch.models.diff_gnn import DiffGNN
    from ab_opt_tpu_torch.models.diffab import DiffAb
    cls = DiffAb if model == 'diffab' else DiffGNN
    real = cls.loss

    def loss(self, *a, **k):
        out = real(self, *a, **k)
        return dict(out, rot=out['rot'] * 1.01)
    monkeypatch.setattr(cls, 'loss', loss)


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'token', 'wrong_t',
                                   'stale_draws', 'late_token'])
def test_sample_faults_fail(monkeypatch, fault):
    plant = {'unchanged': _fault_sample_unchanged, 'half': _fault_sample_half,
             'token': _fault_sample_token}.get(fault)
    if plant is None:
        # A fault of the steps after the first: only they can show it.
        sample_fault(fault, monkeypatch.setattr)
    else:
        plant(monkeypatch)
    r = _run(bench_tiny.cell('sample', 'diffab'))
    assert not r['correct'], r['checks']
    if plant is None:
        first = ('first_pos_gap_rms_A', 'first_rot_gap_median')
        assert all(r['checks'][n]['value'] <= r['checks'][n]['limit']
                   for n in first), r['checks']


@pytest.mark.parametrize('model', ['diffab', 'gnn'])
@pytest.mark.parametrize('fault', ['unchanged', 'half', 'answer', 'late'])
def test_train_faults_fail(monkeypatch, fault, model):
    cell = bench_tiny.cell('train', model)
    if fault == 'unchanged':
        _fault_train_unchanged(monkeypatch)
    elif fault == 'late':
        _fault_train_late(monkeypatch)
    elif fault == 'answer':
        _fault_train_answer(monkeypatch, model)
    else:
        monkeypatch.setitem(run_cell.DRIVERS, 'train',
                            half_batch(run_cell.DRIVERS['train']))
    r = _run(cell)
    assert not r['correct'], r['checks']
