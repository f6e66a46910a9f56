"""The port's spans (``utils/profiling.py::span``) on the CPU:

* off (no ``torch.profiler`` session), ``span`` is one shared no-op and
  records nothing;
* under a session, a tiny ``DiffAb.sample`` (L=16, one layer, three steps)
  records ``sample``, then three ``sample.step``, each with one
  ``denoiser.encoder`` child, all under one request id, and
  ``DiffAb.optimize`` a ``sample`` root of its own;
* a tiny ``Trainer.train_step`` records ``train.step`` (its request the
  iteration) with ``train.optimizer`` inside it;
* every record lies inside its ``record_function`` event among the same
  session's kineto events, up to 1 ms of clock slack.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ab_opt_tpu_torch.models.diffab import DiffAb, DiffAbConfig
from ab_opt_tpu_torch.train.trainer import Trainer
from ab_opt_tpu_torch.utils import profiling, recorded, span
from ab_opt_tpu_torch.utils.bench_fixture import synthetic_batch

MS = 1_000_000


def _model(num_steps=3):
    torch.manual_seed(0)
    cfg = DiffAbConfig(res_feat_dim=16, pair_feat_dim=8, num_layers=1,
                       num_steps=num_steps)
    batch = synthetic_batch(np.random.default_rng(0), N=1, L=16, n_ab=10,
                            gen_lo=4, gen_hi=8)
    return DiffAb(cfg).eval(), batch


def _session():
    profiling._RECORDS.clear()
    return profile(activities=[ProfilerActivity.CPU])


def _annotations(prof):
    """The session's user annotations: name -> [(start, end)] in order."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for v in out.values():
        v.sort()
    return out


def _assert_on_kineto_clock(prof, spans):
    """Each record lies inside its own ``record_function`` event, up to
    ``MS`` of clock slack: ``span`` takes its times after the event opens
    and before it closes, and a record on another clock would lie far
    outside. (How long a loaded host takes between the two is no bound.)"""
    events = _annotations(prof)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    for name, mine in by_name.items():
        theirs = events[name]
        assert len(theirs) == len(mine), name
        for s, (start, end) in zip(sorted(mine, key=lambda s: s.start),
                                   theirs):
            assert start - MS < s.start <= s.end < end + MS, (
                name, s.start - start, end - s.end)


def test_span_off_is_a_shared_no_op():
    profiling._RECORDS.clear()
    assert not torch.autograd._profiler_enabled()
    a, b = span('sample', request=1), span('k1.layer')
    assert a is b
    with a:
        with b:
            pass
    assert recorded() == []


def test_span_on_records_parents_and_request():
    with _session():
        with span('outer', request=7, x=1):
            with span('inner'):
                pass
            with span('inner'):
                pass
        with span('lone'):
            pass
    got = recorded()
    assert [s.name for s in got] == ['outer', 'inner', 'inner', 'lone']
    assert [s.parent for s in got] == [None, 0, 0, None]
    assert [s.request for s in got] == [7, 7, 7, None]
    assert got[0].attrs == {'request': 7, 'x': 1}
    assert all(s.start <= s.end for s in got)
    assert got[0].start <= got[1].start and got[2].end <= got[0].end


def test_sample_spans_share_one_request():
    model, batch = _model()
    with _session() as prof:
        out = model.sample(batch, generator=torch.Generator().manual_seed(0),
                           num_replicas=2)
    assert out['s'].shape == (2, 16)
    spans = recorded()
    assert [s.name for s in spans] == (
        ['sample'] + ['sample.step', 'denoiser.encoder'] * 3)
    root = spans[0]
    assert root.parent is None and root.attrs['N'] == 2
    assert root.attrs['L'] == 16 and root.request == root.attrs['request']
    steps = [i for i, s in enumerate(spans) if s.name == 'sample.step']
    assert [spans[i].attrs['t'] for i in steps] == [3, 2, 1]
    for i in steps:
        assert spans[i].parent == 0 and spans[i + 1].parent == i
        assert root.start <= spans[i].start <= spans[i + 1].start
        assert spans[i + 1].end <= spans[i].end <= root.end
    assert {s.request for s in spans} == {root.request}
    _assert_on_kineto_clock(prof, spans)


def test_optimize_is_a_request_of_its_own():
    model, batch = _model()
    with _session():
        model.sample(batch, generator=torch.Generator().manual_seed(0))
        model.optimize(batch, opt_step=2,
                       generator=torch.Generator().manual_seed(1))
    roots = [s for s in recorded() if s.name == 'sample']
    assert len(roots) == 2 and roots[1].request == roots[0].request + 1
    second = [s for s in recorded() if s.request == roots[1].request]
    assert [s.name for s in second] == (
        ['sample'] + ['sample.step', 'denoiser.encoder'] * 2)


def test_train_step_spans_carry_the_iteration():
    model, batch = _model(num_steps=5)
    model.train()
    trainer = Trainer(model, {'loss_weights': {'rot': 1.0, 'pos': 1.0,
                                               'seq': 1.0},
                              'max_grad_norm': 100.0,
                              'optimizer': {'type': 'adam', 'lr': 1e-3}},
                      device='cpu')
    gen = torch.Generator().manual_seed(0)
    trainer.train_step(batch, generator=gen)
    with _session() as prof:
        for _ in range(2):
            trainer.train_step(batch, generator=gen, defer_nan_check=True)
        trainer.flush_nan_checks()
    spans = recorded()
    steps = [s for s in spans if s.name == 'train.step']
    assert [s.request for s in steps] == [1, 2]
    assert all(s.parent is None for s in steps)
    opt = [s for s in spans if s.name == 'train.optimizer']
    assert [s.request for s in opt] == [1, 2]
    assert [spans[s.parent].name for s in opt] == ['train.step'] * 2
    for o in opt:
        st = spans[o.parent]
        assert st.start <= o.start <= o.end <= st.end
    _assert_on_kineto_clock(prof, spans)


@pytest.mark.parametrize('inside', [False, True])
def test_span_keeps_the_stack_on_an_exception(inside):
    with _session():
        with pytest.raises(ValueError):
            with span('outer', request=3):
                if inside:
                    with span('inner'):
                        raise ValueError
                raise ValueError
        with span('after'):
            pass
    got = recorded()
    assert got[-1].name == 'after' and got[-1].parent is None
    assert all(s.end is not None for s in got)

