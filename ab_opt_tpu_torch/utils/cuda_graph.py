"""CUDA graphs of a step: capture, replay and a cache of them by shape.

:mod:`..models.step_graph` and :mod:`..train.step_graph` capture a step of
hundreds to thousands of small kernels once as a CUDA graph and replay it:
one launch a step, the same kernels in the same order. Each keeps its own
schedule, and its own check of its route against this rule: a graph
replays what its capture recorded (addresses, Python values, random
numbers), so a step is captured only on a CUDA device, and only if it draws
nothing from a generator inside it (draws are made outside and copied into
static buffers), runs no collective (untried in a graph) and reads no value
that the host counts up for each launch (K5's epoch). A step's inputs are
copied into a graph's static buffers (:func:`load`) and what it returns is
cloned out (:func:`clone`), so that it belongs to the caller. The wrappers'
launch counters (:data:`~..ops.COUNTED`) count what a replay launches; a
capture, nothing.
"""
from __future__ import annotations

import collections
from typing import Callable, Hashable, Sequence, Tuple

import torch

from ..ops import COUNTED

MAX_SHAPES = 4


class ShapeCache(collections.OrderedDict):
    """Entries by key, oldest use first, at most :data:`MAX_SHAPES` of
    them. A copy or a pickle starts empty."""

    def __reduce__(self):
        return type(self), ()

    def get_or_make(self, key: Hashable,
                    make: Callable) -> Tuple[object, bool]:
        """(entry, made): ``key``'s entry, now the most recently used, and
        whether ``make()`` made it (after dropping the least recently used
        entry if the cache was full)."""
        entry = self.pop(key, None)
        made = entry is None
        if made:
            while len(self) >= MAX_SHAPES:
                self.popitem(last=False)
            entry = make()
        self[key] = entry
        return entry, made


def load(dst, src):
    """Copy the tensors of the nest (dicts, lists, tuples) ``src`` into the
    same places of ``dst``, but for keys of ``dst``'s dicts it lacks."""
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, x in dst.items():
            if k in src:
                load(x, src[k])
    elif isinstance(dst, (list, tuple)):
        for x, y in zip(dst, src, strict=True):
            load(x, y)


def clone(tree):
    """``tree`` with every tensor cloned (anything else kept as is)."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(x) for x in tree)
    return tree


def counted(body: Callable, wrappers: Sequence = COUNTED):
    """(``body()``, launches): the pairs (wrapper, what ``body`` added to
    its ``launches``); the counts stand as before ``body`` ran."""
    before = [w.launches for w in wrappers]
    out = body()
    launches = tuple((w, w.launches - n) for w, n in zip(wrappers, before))
    for w, n in zip(wrappers, before):
        w.launches = n
    return out, launches


class Graph:
    """``body`` captured on ``stream`` into ``pool`` (its own if None),
    ``out`` what it returned. Nothing runs until :meth:`replay`."""

    def __init__(self, body: Callable, stream, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode='thread_local')
            try:
                self.out, self.launches = counted(body)
            finally:
                self.graph.capture_end()

    def replay(self):
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
