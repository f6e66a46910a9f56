"""Profiling and determinism helpers (the port's copy of
``ab_opt_tpu/utils/profiling.py``): host-RNG seeding, a ``torch.profiler``
trace around a block, and the program's spans.

A span (:func:`span`) marks a stretch of the program's host time. With no
``torch.profiler`` session active it is one shared no-op context and
records nothing. Inside a session it enters a
``torch.profiler.record_function`` of its name, so it lands in the kineto
trace (and in the Chrome trace :func:`profile_trace` writes), and appends a
:class:`Span` to an in-memory record (:func:`recorded`). Its times are
taken on the clock the kineto events carry (epoch nanoseconds,
``time.time_ns()``), so a record lines up with the session's host and
device events.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def seed_all(seed: int):
    """Seed the host RNGs (``random`` and numpy). The port's device
    randomness comes from explicit generators."""
    random.seed(seed)
    np.random.seed(seed)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile a block with ``torch.profiler`` (the CPU, and CUDA when a card
    is present) and write a Chrome trace, ``<log_dir>/trace.json``, which
    carries the program's spans. Clears the span record first, so that
    :func:`recorded` holds the block's spans. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _RECORDS.clear()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, 'trace.json')
        prof.export_chrome_trace(path)
        logger.info('profiler trace written to %s', path)


@dataclasses.dataclass
class Span:
    """One recorded span: its name, start and end (epoch ns, the kineto
    events' clock; ``end`` None while it is open), the index in
    :func:`recorded` of the span that encloses it (None at the root), the
    request id its root span gave (the root's ``request`` attribute) and
    its own attributes."""
    name: str
    start: int
    end: Optional[int]
    parent: Optional[int]
    request: Any
    attrs: Dict[str, Any]


_RECORDS: List[Span] = []
_OFF = contextlib.nullcontext()


class _Stack(threading.local):
    """This thread's open spans, innermost last (indices in the record)."""

    def __init__(self):
        self.items: List[int] = []


_STACK = _Stack()


class _Recording:
    """An entered span while a profiler session is active."""
    __slots__ = ('name', 'attrs', 'rf', 'index')

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = _STACK.items
        parent = stack[-1] if stack else None
        request = (_RECORDS[parent].request if parent is not None
                   else self.attrs.get('request'))
        self.index = len(_RECORDS)
        _RECORDS.append(Span(self.name, time.time_ns(), None, parent,
                             request, self.attrs))
        stack.append(self.index)
        return self.attrs

    def __exit__(self, *exc):
        _RECORDS[self.index].end = time.time_ns()
        _STACK.items.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager marking a stretch of the program under ``name``
    (``attrs`` kept with the record; a root span's ``request`` is the
    request id of every span inside it). Records only while a
    ``torch.profiler`` session is active; otherwise one shared no-op.
    Entered, it gives the attributes the record keeps (a dict the block may
    add to, for what it learns while it runs), or None when it records
    nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Recording(name, attrs)


def recorded() -> List[Span]:
    """The spans recorded since the record was last cleared (by
    :func:`profile_trace`), in the order they were entered."""
    return list(_RECORDS)
