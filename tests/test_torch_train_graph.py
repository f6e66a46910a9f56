"""The training step replayed as a CUDA graph
(``ab_opt_tpu_torch/train/step_graph.py``) and the device copies of the
constants the step reads.

On the CPU:

* the route: CUDA, one rank and a loss that draws nothing of its own give
  the graph; the CPU, a process group or the graph model with dropout give
  the eager step;
* the schedule's, the IGSO3 tables' and the models' device copies hold the
  host tables' values exactly, are made once a device, and a copy of their
  owner starts with none;
* the CPU trainer's step is the plain step (loss, backward, clip, Adam),
  bit for bit, and its ``train.step`` span says 'eager'.

On an NVIDIA GPU (marker ``cuda``; skips without a card), at full widths
with two layers in bf16 on K2/K3's tile route, under torch's deterministic
algorithms (the embeddings' backward on the card otherwise sums in no
fixed order, so that even two eager runs differ in the last bits):
graphed and eager steps (``Trainer(graph=False)``, capturable Adam too)
agree bit for bit over six steps on two batches with fresh draws (losses,
parameters, Adam's moments and step counts), and the spans say eager,
capture, then replay; a change
of learning rate between replays is followed; a step's returned losses
outlive the next replay; a new batch shape captures anew; a checkpoint of
the graphed route resumes, on the card and on the CPU; the graph model
with dropout stays eager, without it replays; a step waits on the device
nowhere. Imports no
JAX:

    python -m pytest --noconftest -q tests/test_torch_train_graph.py
"""
import copy
import dataclasses
import pickle

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ab_opt_tpu_torch.diffusion import broadcast_coef
from ab_opt_tpu_torch.diffusion.igso3 import sample_igso3_angle
from ab_opt_tpu_torch.diffusion.transitions import (PositionTransition,
                                                    RotationTransition)
from ab_opt_tpu_torch.models import DiffAb, DiffAbConfig, get_model
from ab_opt_tpu_torch.nn.layers import AngularEncoding
from ab_opt_tpu_torch.parallel.distributed import Mesh
from ab_opt_tpu_torch.parallel.mesh import weighted_total
from ab_opt_tpu_torch.train import Trainer
from ab_opt_tpu_torch.train.step_graph import graphable
from ab_opt_tpu_torch.utils import profiling, recorded
from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch

WEIGHTS = {'rot': 1.0, 'pos': 1.0, 'seq': 1.0, 'prmsd': 0.1}
TRAIN_CFG = {'loss_weights': WEIGHTS, 'max_grad_norm': 1.0,
             'optimizer': {'type': 'adam', 'lr': 1e-3}}
GNN = {'type': 'diff_gnn', 'res_feat_dim': 16, 'edge_feat_dim': 8,
       'hidden_size': 16, 'num_steps': 6, 'num_atoms': 3, 'n_layers': 1,
       'hotspot': False, 'objective': 'pred_x0'}


def _tiny(seed=0):
    torch.manual_seed(seed)
    model = DiffAb(DiffAbConfig(res_feat_dim=16, pair_feat_dim=8,
                                num_layers=1, num_steps=5))
    batch = synthetic_batch(np.random.default_rng(seed), N=2, L=16, n_ab=10,
                            gen_lo=4, gen_hi=8)
    return model, batch


def _assert_same_state(model_a, opt_a, model_b, opt_b):
    """Equal parameters and Adam states (moments and step counts), bit
    for bit."""
    for (k, p), q in zip(model_a.named_parameters(), model_b.parameters()):
        assert torch.equal(p, q), k
        sa, sb = opt_a.state.get(p, {}), opt_b.state.get(q, {})
        assert sa.keys() == sb.keys(), k
        for name in sa:
            assert torch.equal(sa[name], sb[name]), (k, name)


def _spans(fn):
    """``fn()`` under a CPU profiler session (so spans record), and the
    ``graph`` tags of its ``train.step`` spans."""
    profiling._RECORDS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s.attrs.get('graph') for s in recorded()
                 if s.name == 'train.step']


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize('model,device,mesh,want', [
    ('diffab', 'cuda', Mesh(), True),
    ('diffab', 'cuda:1', Mesh(), True),
    ('diffab', 'cpu', Mesh(), False),
    ('diffab', 'cuda', Mesh(2, 0, object()), False),
    ('diffab', 'cuda', Mesh(1, 0, object()), False),
    ('gnn_dropout', 'cuda', Mesh(), False),
    ('gnn_no_dropout', 'cuda', Mesh(), True),
    ('undeclared', 'cuda', Mesh(), False)])
def test_route(model, device, mesh, want):
    """Decided from what the trainer sees: the device, the mesh and the
    model's own declaration (a model without one stays eager)."""
    built = {'diffab': lambda: _tiny()[0],
             'gnn_dropout': lambda: get_model(dict(GNN, dropout=0.1)),
             'gnn_no_dropout': lambda: get_model(dict(GNN, dropout=0.0)),
             'undeclared': lambda: torch.nn.Linear(2, 2)}[model]()
    assert graphable(built, device, mesh) is want


SCHEDULE = ('betas', 'alphas', 'alpha_bars', 'sigmas',
            'sqrt_recip_alpha_bars', 'sqrt_recipm1_alpha_bars',
            'posterior_variance', 'posterior_mean_coef1',
            'posterior_mean_coef2')


@pytest.mark.parametrize('name', SCHEDULE)
def test_broadcast_coef_reads_the_host_table(name):
    sched = PositionTransition(100).sched
    t = torch.tensor([[0, 5, 99], [1, 50, 100]])
    got = broadcast_coef(sched, name, t, 4)
    table = getattr(sched, name)
    assert got.shape == (2, 3, 1, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[..., 0, 0].numpy(), table[t.numpy()])
    assert sched.copies(name, 'cpu') is sched.copies(name, 'cpu')


def test_igso3_rows_read_the_host_tables():
    """The per-level rows of the training path equal the numpy tables,
    and so do the angles: the approximation's levels from the stddevs,
    the others from the CDF."""
    rot = RotationTransition(100)
    tables = rot.igso3_fwd
    np.testing.assert_array_equal(tables.copies('stddevs', 'cpu').numpy(),
                                  tables.stddevs)
    np.testing.assert_array_equal(
        tables.copies('approx_flag', 'cpu').numpy(), tables.approx_flag)
    g = torch.Generator().manual_seed(0)
    t = torch.tensor([0, 1, 2, 40, 99])
    shape = (5, 7)
    u, frac = torch.rand(shape, generator=g), torch.rand(shape, generator=g)
    gauss = torch.randn(shape, generator=g)
    got = sample_igso3_angle(tables, t, shape, u=u, frac=frac, gauss=gauss)
    for i, level in enumerate(t.tolist()):
        want = sample_igso3_angle(tables, level, (7,), u=u[i], frac=frac[i],
                                  gauss=gauss[i])
        assert torch.equal(got[i], want), level
    assert tables.approx_flag[:3].any() and not tables.approx_flag[40:].any()


def test_position_affine_and_angular_codes_read_the_config():
    model, _ = _tiny()
    model = DiffAb(dataclasses.replace(model.cfg,
                                       position_mean=(1.0, -2.0, 0.5),
                                       position_scale=(4.0,)))
    p = torch.randn(2, 3, 3)
    mean, scale = model._position_affine(p)
    assert mean.tolist() == [[[1.0, -2.0, 0.5]]]
    assert scale.tolist() == [[[4.0]]]
    torch.testing.assert_close(model.unnormalize_position(
        model.normalize_position(p)), p, atol=1e-6, rtol=0)
    assert model._position_affine(p)[0].data_ptr() == mean.data_ptr()
    enc = AngularEncoding(3)
    x = torch.randn(4, 2, dtype=torch.float64)
    funcs = torch.tensor([1.0, 2.0, 3.0, 1.0, 1 / 2, 1 / 3],
                         dtype=torch.float64)
    y = x[..., None] * funcs
    want = torch.cat([x[..., None], torch.sin(y), torch.cos(y)], dim=-1)
    assert torch.equal(enc(x), want.reshape(4, -1))
    assert enc.copies('funcs', 'cpu', torch.float64).dtype == torch.float64


def test_copies_of_the_owner_start_with_none():
    model, _ = _tiny()
    model._position_affine(torch.zeros(1))
    sched = model.trans_pos.sched
    sched.copies('betas', 'cpu')
    assert model.copies._kept and sched.copies._kept
    for clone in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert not clone.copies._kept
        assert not clone.trans_pos.sched.copies._kept
        assert clone.copies.host == model.copies.host


def test_cpu_step_is_the_plain_step():
    """No graph, Adam as before (a float learning rate, not capturable),
    and the step equals a hand-written one: loss, backward, clip, Adam."""
    model, batch = _tiny()
    plain_model = copy.deepcopy(model)
    trainer = Trainer(model, TRAIN_CFG, device='cpu')
    assert trainer.graphs is None
    group = trainer.optimizer.param_groups[0]
    assert group['capturable'] is False and group['lr'] == 1e-3
    plain = torch.optim.Adam(plain_model.parameters(), lr=1e-3, eps=1e-8,
                             betas=(0.9, 0.999))
    params = [p for p in plain_model.parameters()]
    for i in range(3):
        t, draws = plain_model.loss_draws(
            2, 16, torch.Generator().manual_seed(i))
        got, tags = _spans(lambda: trainer.train_step(batch, t=t,
                                                      draws=draws))
        assert tags == ['eager']
        plain.zero_grad(set_to_none=True)
        losses = plain_model.loss(batch, t=t, draws=draws)
        total = weighted_total(losses, WEIGHTS)
        total.backward()
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        plain.step()
        assert torch.equal(got['overall'], total.detach())
        for k in losses:
            assert torch.equal(got[k], losses[k].detach()), k
    _assert_same_state(model, trainer.optimizer, plain_model, plain)


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA graphs and the kernels have '
                    'no CPU mode)')
    return torch.device('cuda')


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for a test that compares two
    training runs bit for bit (where an op has none, a warning)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _full(dev, seed=0):
    """Full widths, two layers, bf16: the benchmark's training model cut
    in depth."""
    torch.manual_seed(seed)
    return DiffAb(DiffAbConfig(num_layers=2, num_steps=100,
                               obj='pred_noise', dtype='bfloat16')).to(dev)


def _batch(dev, seed, N=4, L=64):
    return synthetic_batch(np.random.default_rng(seed), N=N, L=L, n_ab=40,
                           gen_lo=20, gen_hi=32, device=dev)


def _draws(model, batch, step):
    N, L = batch['aa'].shape
    dev = batch['aa'].device
    return model.loss_draws(N, L, torch.Generator(device=dev).manual_seed(
        1000 + step), dev)


def _pair(dev, **kw):
    """A graphed and an eager trainer on copies of one model."""
    model = _full(dev)
    return (Trainer(model, TRAIN_CFG, device=dev, **kw),
            Trainer(copy.deepcopy(model), TRAIN_CFG, device=dev,
                    graph=False, **kw))


def _step_both(pair, batch, step):
    out = []
    for tr in pair:
        t, draws = _draws(tr.model, batch, step)
        out.append(tr.train_step(batch, t=t, draws=draws,
                                 defer_nan_check=True))
    return out


def _assert_same(a: Trainer, b: Trainer):
    _assert_same_state(a.model, a.optimizer, b.model, b.optimizer)


@pytest.mark.cuda
def test_graph_equals_eager_bit_for_bit(deterministic):
    dev = _card()
    pair = _pair(dev)
    graphed, eager = pair
    assert graphed.optimizer.param_groups[0]['capturable']
    assert eager.optimizer.param_groups[0]['capturable']
    assert graphed.graphs is not None and eager.graphs is None
    batches = [_batch(dev, 0), _batch(dev, 1)]

    def run():
        got = []
        for step in range(6):
            got.append(_step_both(pair, batches[step % 2], step))
        return got

    steps, tags = _spans(run)
    assert tags[0::2] == ['eager', 'capture'] + ['replay'] * 4
    assert tags[1::2] == ['eager'] * 6
    for g, e in steps:
        assert g.keys() == e.keys()
        for k in e:
            assert torch.equal(g[k], e[k]), k
    _assert_same(graphed, eager)
    graphed.flush_nan_checks()
    assert len(graphed.loss_history['overall']) == 6
    assert len(graphed.graphs) == 1


@pytest.mark.cuda
def test_learning_rate_change_between_replays(deterministic):
    dev = _card()
    pair = _pair(dev)
    batch = _batch(dev, 0)
    for step in range(3):
        _step_both(pair, batch, step)
    before = [p.detach().clone() for p in pair[0].model.parameters()]
    for tr in pair:
        tr._set_lr(0.0)
    _step_both(pair, batch, 3)
    for p, q in zip(pair[0].model.parameters(), before):
        assert torch.equal(p, q)
    for tr in pair:
        tr._set_lr(3e-3)
    for step in (4, 5):
        _step_both(pair, batch, step)
    _assert_same(*pair)
    assert any(not torch.equal(p, q)
               for p, q in zip(pair[0].model.parameters(), before))


@pytest.mark.cuda
def test_returned_losses_outlive_the_next_replay():
    dev = _card()
    graphed, _ = _pair(dev)
    batches = [_batch(dev, 0), _batch(dev, 1)]
    for step in range(2):
        t, d = _draws(graphed.model, batches[step % 2], step)
        graphed.train_step(batches[step % 2], t=t, draws=d,
                           defer_nan_check=True)
    t, d = _draws(graphed.model, batches[0], 2)
    first = graphed.train_step(batches[0], t=t, draws=d,
                               defer_nan_check=True)
    kept = {k: v.clone() for k, v in first.items()}
    t, d = _draws(graphed.model, batches[1], 3)
    second = graphed.train_step(batches[1], t=t, draws=d,
                                defer_nan_check=True)
    torch.cuda.synchronize()
    assert not torch.equal(first['overall'], second['overall'])
    for k in kept:
        assert torch.equal(first[k], kept[k]), k


@pytest.mark.cuda
def test_new_batch_shape_captures_anew(deterministic):
    dev = _card()
    pair = _pair(dev)
    shapes = [_batch(dev, 0), _batch(dev, 1, N=2, L=48)]

    def run():
        for step in range(6):
            _step_both(pair, shapes[step // 3], step)

    _, tags = _spans(run)
    assert tags[0::2] == ['eager', 'capture', 'replay'] * 2
    assert len(pair[0].graphs) == 2
    _assert_same(*pair)


@pytest.mark.cuda
def test_checkpoint_of_the_graphed_route_resumes(tmp_path, deterministic):
    dev = _card()
    cfg = dict(TRAIN_CFG, scheduler=None)
    first = Trainer(_full(dev), cfg, log_dir=str(tmp_path), device=dev)
    batch = _batch(dev, 0)
    for step in range(3):
        t, d = _draws(first.model, batch, step)
        first.train_step(batch, t=t, draws=d)
    first._set_lr(5e-4)
    path = first.save()

    fresh = Trainer(_full(dev, seed=1), cfg, device=dev)
    fresh.resume(path)
    assert fresh.iteration == 3 and fresh.lr == 5e-4
    assert fresh.optimizer.param_groups[0]['lr'] is fresh._lr_cell
    _assert_same(first, fresh)

    def run():
        for step in (3, 4, 5):
            for tr in (first, fresh):
                t, d = _draws(tr.model, batch, step)
                tr.train_step(batch, t=t, draws=d)

    _, tags = _spans(run)
    assert tags[0::2] == ['replay'] * 3
    assert tags[1::2] == ['eager', 'capture', 'replay']
    _assert_same(first, fresh)

    cpu = Trainer(_full('cpu', seed=2), cfg, device='cpu')
    cpu.resume(path)
    group = cpu.optimizer.param_groups[0]
    assert group['capturable'] is False and group['lr'] == 5e-4
    state = cpu.optimizer.state[next(cpu.model.parameters())]
    assert state['step'].device.type == 'cpu' and float(state['step']) == 3


@pytest.mark.cuda
@pytest.mark.parametrize('dropout', [0.1, 0.0])
def test_graph_model_route(dropout, deterministic):
    """The graph model with dropout draws its masks in the loss and stays
    eager; without, it replays its graph like DiffAb, bit for bit the
    eager step."""
    dev = _card()
    weights = {'rot': 1.0, 'pos': 1.0, 'bb_pos': 1.0, 'seq': 1.0}
    cfg = dict(TRAIN_CFG, loss_weights=weights)
    torch.manual_seed(0)
    model = get_model(dict(GNN, dropout=dropout))
    pair = (Trainer(model, cfg, device=dev),
            Trainer(copy.deepcopy(model), cfg, device=dev, graph=False))
    assert (pair[0].graphs is None) == (dropout > 0)
    assert pair[0].optimizer.param_groups[0]['capturable'] == (dropout == 0)
    batch = synthetic_batch(np.random.default_rng(0), N=2, L=32, n_ab=20,
                            gen_lo=8, gen_hi=14, device=dev)
    gens = [torch.Generator(device=dev).manual_seed(0) for _ in pair]

    def run():
        return [[tr.train_step(batch, g) for tr, g in zip(pair, gens)]
                for _ in range(3)]

    steps, tags = _spans(run)
    want = ['eager'] * 3 if dropout else ['eager', 'capture', 'replay']
    assert tags[0::2] == want and tags[1::2] == ['eager'] * 3
    assert all(torch.isfinite(v).all() for v in steps[-1][0].values())
    if not dropout:
        for g, e in steps:
            for k in e:
                assert torch.equal(g[k], e[k]), k
        _assert_same(*pair)


@pytest.mark.cuda
@pytest.mark.parametrize('graph', [True, False])
def test_a_step_waits_on_the_device_nowhere(graph):
    """After a shape's warm-up and capture, a step (replayed or eager)
    makes no synchronising call: the constants it reads already lie on
    the card and the finite check is read one step late."""
    dev = _card()
    model = _full(dev)
    trainer = Trainer(model, TRAIN_CFG, device=dev, graph=graph)
    batch = _batch(dev, 0)
    for step in range(3):
        t, d = _draws(model, batch, step)
        trainer.train_step(batch, t=t, draws=d)
    t, d = _draws(model, batch, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        trainer.train_step(batch, t=t, draws=d, defer_nan_check=True)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    trainer.flush_nan_checks()
    assert len(trainer.loss_history['overall']) == 4
