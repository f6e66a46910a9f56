"""The readers of the program's spans on made-up records and trace views:
each value by hand, None where the record holds none of the reader's
spans, and None where the program has no span record at all."""
import json
import sys
import types

import pytest

from bench_tiny import BENCH  # noqa: F401  (puts the benchmark on the path)
from harness.manifest import metric_reader
from harness.trace import TraceView

from ab_opt_tpu_torch.utils import profiling
from ab_opt_tpu_torch.utils.profiling import Span

READERS = ('host_ms_per_step.sample', 'glue_launches_per_step.sample',
           'request_self_ms.sample', 'idle_in_loop_pct.sample',
           'k1_host_us_per_layer', 'host_ms_per_step.train',
           'host_syncs_per_step.train', 'optimizer_launches_per_step.train')
US = 1_000


def _view(host_ops=(), device_ops=(), window_s=1.0):
    return TraceView([], list(device_ops), list(host_ops), window_s, 0.0,
                     {'steps': 2}, None, {})


def _record(monkeypatch, spans):
    monkeypatch.setattr(profiling, 'recorded', lambda: list(spans))


def _sampling():
    """One request: 'sample' 0-1000 us; two steps, 100-400 and 500-900,
    each with an encoder 150-300 / 550-800 holding one K1 layer."""
    return [Span('sample', 0, 1000 * US, None, 0, {'request': 0}),
            Span('sample.step', 100 * US, 400 * US, 0, 0, {'t': 2}),
            Span('denoiser.encoder', 150 * US, 300 * US, 1, 0, {}),
            Span('k1.layer', 160 * US, 200 * US, 2, 0, {}),
            Span('sample.step', 500 * US, 900 * US, 0, 0, {'t': 1}),
            Span('denoiser.encoder', 550 * US, 800 * US, 4, 0, {}),
            Span('k1.layer', 600 * US, 660 * US, 5, 0, {})]


def _training():
    """Two steps, 0-100 and 200-350 ms, each with its optimizer span."""
    ms = 1000 * US
    return [Span('train.step', 0, 100 * ms, None, 5, {'request': 5}),
            Span('train.optimizer', 60 * ms, 90 * ms, 0, 5, {}),
            Span('train.step', 200 * ms, 350 * ms, None, 6, {'request': 6}),
            Span('train.optimizer', 300 * ms, 340 * ms, 2, 6, {})]


def test_host_times(monkeypatch):
    _record(monkeypatch, _sampling())
    view = _view()
    assert metric_reader('host_ms_per_step.sample')(view) == \
        pytest.approx(0.35)
    assert metric_reader('k1_host_us_per_layer')(view) == pytest.approx(50)
    # 1000 us less the steps' 300 and 400.
    assert metric_reader('request_self_ms.sample')(view) == \
        pytest.approx(0.3)
    _record(monkeypatch, _training())
    assert metric_reader('host_ms_per_step.train')(view) == \
        pytest.approx(125)


def test_glue_launches_leave_out_the_encoder(monkeypatch):
    _record(monkeypatch, _sampling())
    launch = lambda us, name='cudaLaunchKernel': (name, us * US, 2 * US)
    host = [launch(50),                                   # before the steps
            launch(110), launch(120, 'cudaLaunchKernelExC'),
            launch(170), launch(250, 'cuLaunchKernel'),   # in the encoder
            launch(350, 'cudaGraphLaunch'),
            ('cudaMemcpyAsync', 360 * US, US), ('aten::mul', 370 * US, US),
            launch(400),                                  # at a step's end
            launch(520, 'cuLaunchKernelEx'),
            launch(700),                                  # in the encoder
            launch(850, 'cudaLaunchCooperativeKernel'), launch(950)]
    # Step 1: 110, 120, 350; step 2: 520, 850.
    got = metric_reader('glue_launches_per_step.sample')(_view(host))
    assert got == pytest.approx(2.5)


def test_training_launches_and_syncs(monkeypatch):
    _record(monkeypatch, _training())
    ms = 1000 * US
    host = [('cudaLaunchKernel', 10 * ms, US),
            ('cudaLaunchKernel', 61 * ms, US),
            ('cudaLaunchKernelExC', 89 * ms, US),
            ('cudaStreamSynchronize', 5 * ms, US),
            ('cudaMemcpyAsync', 6 * ms, US),
            ('cudaLaunchKernel', 310 * ms, US),
            ('cudaGraphLaunch', 320 * ms, US),
            ('cudaLaunchKernel', 345 * ms, US),
            ('cudaMemcpy', 210 * ms, US),
            ('cudaEventSynchronize', 220 * ms, US),
            ('cudaDeviceSynchronize', 360 * ms, US)]
    view = _view(host)
    assert metric_reader('optimizer_launches_per_step.train')(view) == 2.0
    assert metric_reader('host_syncs_per_step.train')(view) == 1.5


def test_idle_in_loop(monkeypatch):
    _record(monkeypatch, _sampling())
    # Busy 50-150, 120-200 (overlapping), 380-600, 850-950 us: inside the
    # steps 100-400 covers 100-200 and 380-400, 500-900 covers 500-600 and
    # 850-900; idle 180 + 250 = 430 us of a 2 ms window.
    dev = [('k', 50 * US, 100 * US), ('k', 120 * US, 80 * US),
           ('Memcpy', 380 * US, 220 * US), ('k', 850 * US, 100 * US)]
    got = metric_reader('idle_in_loop_pct.sample')(_view(device_ops=dev,
                                                         window_s=2e-3))
    assert got == pytest.approx(21.5)
    assert metric_reader('idle_in_loop_pct.sample')(_view()) is None


@pytest.mark.parametrize('name', READERS)
def test_none_without_its_spans(monkeypatch, name):
    ops = [('cudaLaunchKernel', 10, 5), ('cudaStreamSynchronize', 20, 5)]
    view = _view(ops, [('k', 0, 100)])
    other = [Span('unrelated', 0, 100, None, None, {}),
             Span('sample.step', 0, None, None, None, {})]   # still open
    _record(monkeypatch, other)
    assert metric_reader(name)(view) is None
    # A program with no span record (before spans existed).
    monkeypatch.setitem(sys.modules, 'ab_opt_tpu_torch.utils.profiling',
                        types.ModuleType('profiling'))
    assert metric_reader(name)(view) is None


def test_every_reader_is_in_the_manifest():
    with open(BENCH.parent / 'BENCHMARK.json') as f:
        entries = {m['name']: m for m in json.load(f)['per_layer']}
    for name in READERS:
        m = entries[name]
        assert m['source'] == 'device_trace'
        assert (BENCH / 'metrics' / f'{name}.py').exists()
