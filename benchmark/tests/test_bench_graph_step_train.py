"""The reader of ``graph_step_pct.train`` on made-up span records: the
share of ``train.step`` spans that replayed a CUDA graph, and None where
the record holds no tagged step or the program has no span record."""
import json
import sys
import types

import pytest

from bench_tiny import BENCH  # noqa: F401  (puts the benchmark on the path)
from harness.manifest import metric_reader
from harness.trace import TraceView

from ab_opt_tpu_torch.utils import profiling
from ab_opt_tpu_torch.utils.profiling import Span

NAME = 'graph_step_pct.train'
US = 1_000


def _view():
    return TraceView([], [('k', 0, 100)], [('cudaGraphLaunch', 10, 5)], 1.0,
                     0.0, {'steps': 2}, None, {})


def _steps(modes):
    """One closed ``train.step`` a mode, each its own request (the
    iteration), with ``train.optimizer`` inside the eager and captured
    ones; the step's ``graph`` tag is its mode (no tag where it is
    None)."""
    spans = []
    for i, mode in enumerate(modes):
        attrs = {'request': i}
        if mode is not None:
            attrs['graph'] = mode
        start = 200 * i * US
        spans.append(Span('train.step', start, start + 150 * US, None, i,
                          attrs))
        if mode != 'replay':
            spans.append(Span('train.optimizer', start + 100 * US,
                              start + 140 * US, len(spans) - 1, i, {}))
    return spans


@pytest.mark.parametrize('modes,want', [
    (('replay', 'replay'), 100.0), (('eager', 'eager'), 0.0),
    (('capture', 'replay'), 50.0), (('eager', 'capture', 'replay',
                                     'replay'), 50.0),
    ((None, None), None), ((), None)])
def test_graph_step_share(monkeypatch, modes, want):
    """Steps with no ``graph`` tag (a program from before the training
    graphs) are left out; with none tagged the reader gives None."""
    monkeypatch.setattr(profiling, 'recorded', lambda: _steps(modes))
    got = metric_reader(NAME)(_view())
    assert got == (None if want is None else pytest.approx(want))


def test_open_steps_and_other_spans_are_left_out(monkeypatch):
    spans = [Span('sample.step', 0, 100, None, None, {'graph': 'replay'}),
             Span('train.step', 0, None, None, None, {'graph': 'replay'})]
    monkeypatch.setattr(profiling, 'recorded', lambda: spans)
    assert metric_reader(NAME)(_view()) is None
    monkeypatch.setattr(profiling, 'recorded',
                        lambda: spans + _steps(('eager',)))
    assert metric_reader(NAME)(_view()) == 0.0


def test_none_without_a_span_record(monkeypatch):
    monkeypatch.setitem(sys.modules, 'ab_opt_tpu_torch.utils.profiling',
                        types.ModuleType('profiling'))
    assert metric_reader(NAME)(_view()) is None


def test_reader_is_in_the_manifest():
    with open(BENCH.parent / 'BENCHMARK.json') as f:
        bench = json.load(f)
    entries = {m['name']: m for m in bench['per_layer']}
    m = entries[NAME]
    assert m['source'] == 'device_trace'
    assert m['moves'] == 'train_samples_per_s'
    assert m['unit'] == '%' and m['better'] == 'higher'
    assert m['layer'] == entries['host_ms_per_step.train']['layer']
    assert m['workloads'] == ['codesign-train16-L128', 'gnn-train16-L192']
    assert bench['per_layer'][-1] is m
    assert (BENCH / 'metrics' / f'{NAME}.py').exists()
