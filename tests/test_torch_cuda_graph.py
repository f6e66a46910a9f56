"""The CUDA-graph mechanism the sampler's and the trainer's step graphs
share (``ab_opt_tpu_torch/utils/cuda_graph.py``), on the CPU: the shape
cache's order, eviction and empty copies; the static buffers' copy in and
clone out; the launch counters' accounting around a capture and at each
replay, with torch's graph and stream stood in for. The graphs themselves
run on the card in ``test_torch_step_graph.py`` and
``test_torch_train_graph.py``."""
import contextlib
import copy
import pickle

import pytest
import torch

from ab_opt_tpu_torch import ops
from ab_opt_tpu_torch.models.step_graph import StepGraphs
from ab_opt_tpu_torch.utils import cuda_graph
from ab_opt_tpu_torch.utils.cuda_graph import (MAX_SHAPES, Graph, ShapeCache,
                                               clone, counted, load)


def _fill(cache, keys):
    for k in keys:
        cache.get_or_make(k, lambda k=k: f'entry {k}')


def test_a_hit_refreshes_and_the_fifth_key_evicts_the_oldest():
    cache = ShapeCache()
    _fill(cache, range(MAX_SHAPES))
    assert cache.get_or_make(0, pytest.fail) == ('entry 0', False)
    made = []
    assert cache.get_or_make('new', lambda: made.append(1) or 'n') == (
        'n', True)
    assert made == [1] and len(cache) == MAX_SHAPES
    assert list(cache) == [2, 3, 0, 'new']      # 1 was the oldest use
    entry, made = cache.get_or_make(1, lambda: 'again')
    assert (entry, made) == ('again', True) and 2 not in cache


def test_clear_empties_the_cache():
    cache = ShapeCache()
    _fill(cache, 'ab')
    cache.clear()
    assert len(cache) == 0
    assert cache.get_or_make('a', lambda: 'fresh') == ('fresh', True)


@pytest.mark.parametrize('kind', [ShapeCache, StepGraphs])
@pytest.mark.parametrize('how', ['copy', 'deepcopy', 'pickle'])
def test_copies_and_pickles_start_empty(kind, how):
    cache = kind()
    _fill(cache, 'abc')
    other = {'copy': copy.copy, 'deepcopy': copy.deepcopy,
             'pickle': lambda c: pickle.loads(pickle.dumps(c))}[how](cache)
    assert type(other) is kind and len(other) == 0 and len(cache) == 3


def _counter(n=0):
    def wrapper():
        wrapper.launches += 1
    wrapper.launches = n
    return wrapper


def test_counted_restores_the_counts_and_returns_what_the_body_added():
    a, b = _counter(5), _counter(7)

    def body():
        a(), a(), b()
        return 'out'

    out, launches = counted(body, (a, b))
    assert out == 'out' and (a.launches, b.launches) == (5, 7)
    assert launches == ((a, 2), (b, 1))


class _FakeGraph:
    """Records what the capture asked for; replays nothing."""

    def __init__(self):
        self.calls = []

    def capture_begin(self, **kw):
        self.calls.append(('begin', kw))

    def capture_end(self):
        self.calls.append('end')

    def replay(self):
        self.calls.append('replay')


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeGraph)
    monkeypatch.setattr(torch.cuda, 'stream', contextlib.nullcontext)


@pytest.mark.parametrize('pool', [None, 'pool'])
def test_a_capture_counts_nothing_and_a_replay_adds_its_launches(
        fake_cuda, pool):
    k1 = ops.gablock.gablock_layer
    start = k1.launches

    def body():
        k1.launches += 6        # what six launches of K1 count
        return 'out'

    graph = Graph(body, 'stream', pool)
    assert graph.out == 'out' and k1.launches == start
    assert graph.graph.calls == [
        ('begin', {'pool': pool, 'capture_error_mode': 'thread_local'}),
        'end']
    graph.replay()
    graph.replay()
    assert k1.launches == start + 12
    assert graph.graph.calls[2:] == ['replay', 'replay']
    assert dict(graph.launches)[k1] == 6
    assert all(n == 0 for w, n in graph.launches if w is not k1)


def test_a_failed_capture_still_ends(fake_cuda, monkeypatch):
    graphs = []
    monkeypatch.setattr(torch.cuda, 'CUDAGraph',
                        lambda: graphs.append(_FakeGraph()) or graphs[-1])
    with pytest.raises(ValueError):
        Graph(lambda: (_ for _ in ()).throw(ValueError('body')), 'stream')
    assert graphs[0].calls[-1] == 'end'


def test_counted_lists_every_wrapper_with_a_launch_counter():
    """Each wrapper of ``ops`` that counts its launches is in
    ``ops.COUNTED``, so a capture corrects every counter."""
    counters = {id(f) for mod in (ops.gablock, ops.ipa_attention)
                for f in vars(mod).values() if hasattr(f, 'launches')}
    assert counters == {id(f) for f in ops.COUNTED}
    assert cuda_graph.COUNTED is ops.COUNTED


def test_load_copies_into_the_same_places():
    dst = ({'a': torch.zeros(2), 'b': [torch.zeros(1), 3]},
           torch.zeros(3), {'kept': torch.ones(1)})
    keep = dst[0]['a'], dst[1]
    load(dst, ({'a': torch.ones(2), 'b': [torch.full((1,), 2.), 4]},
               torch.arange(3.), {}))
    assert dst[0]['a'] is keep[0] and dst[1] is keep[1]
    assert dst[0]['a'].tolist() == [1, 1] and dst[0]['b'][0].item() == 2
    assert dst[0]['b'][1] == 3 and dst[1].tolist() == [0, 1, 2]
    assert dst[2]['kept'].item() == 1
    with pytest.raises(ValueError):
        load((torch.zeros(1),), (torch.zeros(1), torch.zeros(1)))


def test_clone_copies_tensors_and_keeps_the_nest():
    x = torch.arange(3.)
    tree = {'x': x, 'rest': (x, [x, 'tag']), 'n': None}
    got = clone(tree)
    assert type(got['rest']) is tuple and type(got['rest'][1]) is list
    assert got['rest'][1][1] == 'tag' and got['n'] is None
    for y in (got['x'], got['rest'][0], got['rest'][1][0]):
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
