"""DiffAb's reverse step replayed as a CUDA graph
(``ab_opt_tpu_torch/models/step_graph.py``).

On the CPU:

* the step's noise drawn ahead of the step from a generator
  (``DiffAb.step_noise``) is what the eager step draws inline: the same
  step, bit for bit, and the generator left in the same state;
* the level a step captures ahead is the reverse loop's next;
* the CPU path binds no graph, and a copy of the model starts with none.

On an NVIDIA GPU (marker ``cuda``; skips without a card), at full widths
with two K1 layers: graph sampling equals eager sampling (``graph=False``)
bit for bit over whole ``sample`` calls with ``keep_traj``, with draws and
with a generator, its first call capturing every level and the next
replaying them, and each counting the eager call's K1 launches; a later
call leaves an earlier call's tensors alone; new
weights are picked up; a new shape captures a new set of graphs;
``optimize``, a strided call and the K4 route replay too. Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_step_graph.py
"""
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ab_opt_tpu_torch.geometry import rotation_to_so3vec
from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig
from ab_opt_tpu_torch.ops import gablock as gb
from ab_opt_tpu_torch.ops import ipa_attention as ia
from ab_opt_tpu_torch.utils import profiling, recorded
from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch


def _tiny():
    torch.manual_seed(0)
    model = DiffAb(DiffAbConfig(res_feat_dim=16, pair_feat_dim=8,
                                num_layers=1, num_steps=5)).eval()
    batch = synthetic_batch(np.random.default_rng(0), N=1, L=16, n_ab=10,
                            gen_lo=4, gen_hi=8)
    return model, batch


def _step_args(model, batch, reps=2):
    """(v, p, s, res_feat, pair_feat, mask_generate, mask_res, denoiser)
    of a fan-out of ``reps`` from the native state."""
    rep = lambda a: a.repeat_interleave(reps, 0)
    res_feat, pair_feat, R0, p0 = model.encode(batch, True, True)
    mres = rep(batch['mask'])
    return (rotation_to_so3vec(rep(R0)), model.normalize_position(rep(p0)),
            rep(batch['aa']).long(), rep(res_feat), pair_feat,
            rep(batch['generate_flag']), mres,
            model.prepare_denoiser(pair_feat, mres, reps))


@pytest.mark.parametrize('t,t_next,given', [
    (4, None, ()), (1, None, ()), (4, 2, ()), (3, None, ('pos', 'rot_u'))])
def test_noise_drawn_ahead_equals_inline(t, t_next, given):
    """An ancestral step above and at t = 1 (no position draw there), a
    strided one (none either) and one with some draws given."""
    model, batch = _tiny()
    reps = 2
    with torch.no_grad():
        v, p, s, res_feat, pair_feat, gen, mres, den = _step_args(
            model, batch, reps)
        fixed = {k: torch.randn(v.shape if k == 'pos' else v.shape[:2])
                 for k in given}
        g_inline = torch.Generator().manual_seed(7)
        g_ahead = torch.Generator().manual_seed(7)
        args = (v, p, s, t, res_feat, pair_feat, gen, mres, den, reps)
        want = model.reverse_step(*args, dict(fixed), g_inline,
                                  t_next=t_next)
        noise = model.step_noise(s.shape, t, t_next, dict(fixed), g_ahead)
        got = model.reverse_step(*args, noise, None, t_next=t_next)
    for k in given:
        assert noise[k] is fixed[k]
    assert ('pos' in noise) == ('pos' in given or (t_next is None and t > 1))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(g_ahead.get_state(), g_inline.get_state())


@pytest.mark.parametrize('t_start,stride', [(100, 1), (64, 1), (100, 5),
                                            (7, 3), (6, 4)])
def test_next_level_walks_the_reverse_loop(t_start, stride):
    """The level a step captures ahead is the loop's next one (the levels
    ``DiffAb._reverse_loop`` steps through), and none after the last."""
    from ab_opt_tpu_torch.models.step_graph import _next_level
    levels = [(t, None if stride == 1 else max(t - stride, 0))
              for t in range(t_start, 0, -stride)]
    assert [_next_level(*lv) for lv in levels] == levels[1:] + [None]


def test_cpu_binds_no_graph_and_copies_start_empty():
    model, batch = _tiny()
    kw = dict(num_replicas=2, keep_traj=True)
    out = model.sample(batch, generator=torch.Generator().manual_seed(0),
                       **kw)
    eager = model.sample(batch, generator=torch.Generator().manual_seed(0),
                         graph=False, **kw)
    assert len(model.step_graphs) == 0
    for k in ('v', 'p', 's', 'prmsd', 'perplexity'):
        assert torch.equal(out[k], eager[k]), k
    model.step_graphs.get_or_make('shape', object)
    assert len(copy.deepcopy(model).step_graphs) == 0
    assert len(model.step_graphs) == 1


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs and the kernels have '
                    'no CPU mode)')
    return torch.device('cuda')


def _full(dev, ipa_impl='auto', L=64):
    """Full widths, two layers, six steps, bf16: the benchmark's model
    cut in depth and length."""
    torch.manual_seed(0)
    model = DiffAb(DiffAbConfig(num_layers=2, num_steps=6, obj='pred_noise',
                                dtype='bfloat16', ipa_impl=ipa_impl)
                   ).eval().to(dev)
    batch = synthetic_batch(np.random.default_rng(0), N=1, L=L, n_ab=40,
                            gen_lo=20, gen_hi=32, device=dev)
    return model, batch


def _draws(model, N, L, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    steps = [model.step_noise((N, L), 2, generator=g, device=dev)
             for _ in range(model.cfg.num_steps)]
    return {'init_quat': torch.randn(N, L, 4, generator=g, device=dev),
            'init_pos': torch.randn(N, L, 3, generator=g, device=dev),
            'init_seq': torch.randint(0, 19, (N, L), generator=g,
                                      device=dev),
            'steps': steps}


def _flat(out):
    return {k: x for k, x in out.items() if k != 'traj'} | {
        'traj.' + k: x for k, x in out.get('traj', {}).items()}


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# A shape's first call: each step captures the next level's graph (the
# first its own too), the last has none to capture.
FIRST_CALL = {n: ['capture'] * (n - 1) + ['replay'] for n in (3, 4, 6)}


def _launches():
    return (gb.gablock_layer.launches, ia.ipa_attention_fwd_p2n.launches)


def _modes(fn):
    """``fn()`` under a profiler session (so spans record), the ``graph``
    tags of its ``sample.step`` spans and the K1 and K4 launches it
    counted."""
    profiling._RECORDS.clear()
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    torch.cuda.synchronize()
    counted = tuple(b - a for a, b in zip(before, _launches()))
    return out, [s.attrs['graph'] for s in recorded()
                 if s.name == 'sample.step'], counted


@pytest.mark.cuda
@pytest.mark.parametrize('source', ['draws', 'generator'])
def test_graph_sample_equals_eager_on_card(source):
    dev = _card()
    model, batch = _full(dev)
    reps, L = 4, batch['aa'].shape[1]

    def call(graph, seed=3):
        if source == 'draws':
            kw = {'draws': _draws(model, reps, L, dev, seed)}
        else:
            kw = {'generator': torch.Generator(device=dev).manual_seed(seed)}
        return model.sample(batch, num_replicas=reps, keep_traj=True,
                            graph=graph, **kw)

    want, modes, eager = _modes(lambda: call(False))
    assert modes == ['eager'] * 6 and eager == (6 * 2, 0)
    _assert_same(call(False), want)        # eager is deterministic
    first, modes, counted = _modes(lambda: call(True))
    assert modes == FIRST_CALL[6] and counted == eager
    second, modes, counted = _modes(lambda: call(True))
    assert modes == ['replay'] * 6 and counted == eager
    _assert_same(first, want)
    _assert_same(second, want)
    assert len(model.step_graphs) == 1


@pytest.mark.cuda
def test_a_later_call_leaves_earlier_results_alone_on_card():
    dev = _card()
    model, batch = _full(dev)
    L = batch['aa'].shape[1]
    run = lambda seed: model.sample(batch, num_replicas=4, keep_traj=True,
                                    draws=_draws(model, 4, L, dev, seed))
    first = run(1)
    kept = {k: x.clone() for k, x in _flat(first).items()}
    second = run(2)
    torch.cuda.synchronize()
    for k, x in _flat(first).items():
        assert torch.equal(x, kept[k]), k
    assert not torch.equal(second['p'], first['p'])


@pytest.mark.cuda
def test_new_weights_are_picked_up_on_card():
    dev = _card()
    model, batch = _full(dev)
    L = batch['aa'].shape[1]
    draws = _draws(model, 4, L, dev, 5)
    run = lambda graph: model.sample(batch, num_replicas=4, draws=draws,
                                     graph=graph)
    before = run(True)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)
    after, modes, _ = _modes(lambda: run(True))
    assert modes == ['replay'] * 6
    _assert_same(after, run(False))
    assert not torch.equal(after['p'], before['p'])


@pytest.mark.cuda
def test_a_new_shape_captures_new_graphs_on_card():
    dev = _card()
    model, batch = _full(dev)
    L = batch['aa'].shape[1]
    for reps in (4, 2):
        draws = _draws(model, reps, L, dev, 9)
        run = lambda graph: model.sample(batch, num_replicas=reps,
                                         draws=draws, graph=graph)
        got, modes, _ = _modes(lambda: run(True))
        assert modes == FIRST_CALL[6]
        _assert_same(got, run(False))
    assert len(model.step_graphs) == 2
    _, modes, _ = _modes(lambda: run(True))
    assert modes == ['replay'] * 6


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['optimize', 'strided', 'k4'])
def test_optimize_strided_and_k4_replay_on_card(kind):
    dev = _card()
    model, batch = _full(dev, ipa_impl='pallas' if kind == 'k4' else 'auto')
    L = batch['aa'].shape[1]
    gen = lambda: torch.Generator(device=dev).manual_seed(11)
    if kind == 'optimize':
        rows = {k: x.repeat_interleave(3, 0) for k, x in batch.items()}
        run = lambda graph: model.optimize(rows, opt_step=4, generator=gen(),
                                           keep_traj=True, graph=graph)
        steps = 4
    else:
        stride = 2 if kind == 'strided' else 1
        run = lambda graph: model.sample(
            batch, num_replicas=3, stride=stride, keep_traj=True,
            draws=_draws(model, 3, L, dev, 13), graph=graph)
        steps = 6 // stride
    want, _, eager = _modes(lambda: run(False))
    assert eager == ((0, steps * 2) if kind == 'k4' else (steps * 2, 0))
    first, modes, counted = _modes(lambda: run(True))
    assert modes == FIRST_CALL[steps] and counted == eager
    second, modes, counted = _modes(lambda: run(True))
    assert modes == ['replay'] * steps and counted == eager
    _assert_same(first, want)
    _assert_same(second, want)
