"""The reader of ``graph_step_pct.sample`` on made-up span records: the
share of ``sample.step`` spans that replayed a CUDA graph, and None where
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

NAME = 'graph_step_pct.sample'
US = 1_000


def _view():
    return TraceView([], [('k', 0, 100)], [('cudaGraphLaunch', 10, 5)], 1.0,
                     0.0, {'steps': 2}, None, {})


def _steps(modes):
    """One request 0-1000 us with one closed step a mode, each step's
    ``graph`` tag set to its mode (no tag where the mode is None)."""
    spans = [Span('sample', 0, 1000 * US, None, 0, {'request': 0})]
    for i, mode in enumerate(modes):
        attrs = {'t': len(modes) - i}
        if mode is not None:
            attrs['graph'] = mode
        start = (100 + 200 * i) * US
        spans.append(Span('sample.step', start, start + 150 * US, 0, 0,
                          attrs))
    return spans


@pytest.mark.parametrize('modes,want', [
    (('replay', 'replay'), 100.0), (('eager', 'eager'), 0.0),
    (('capture', 'replay'), 50.0), (('capture', 'replay', 'replay',
                                     'eager'), 50.0),
    ((None, None), None), ((), None)])
def test_graph_step_share(monkeypatch, modes, want):
    """Steps with no ``graph`` tag (a program from before the graphs) are
    left out; with none tagged the reader gives None."""
    monkeypatch.setattr(profiling, 'recorded', lambda: _steps(modes))
    got = metric_reader(NAME)(_view())
    assert got == (None if want is None else pytest.approx(want))


def test_open_steps_and_other_spans_are_left_out(monkeypatch):
    spans = [Span('unrelated', 0, 100, None, None, {'graph': 'replay'}),
             Span('sample.step', 0, None, None, None, {'graph': 'replay'})]
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
        entries = {m['name']: m for m in json.load(f)['per_layer']}
    m = entries[NAME]
    assert m['source'] == 'device_trace'
    assert m['moves'] == 'samples_per_s'
    assert m['unit'] == '%' and m['better'] == 'higher'
    assert (BENCH / 'metrics' / f'{NAME}.py').exists()
