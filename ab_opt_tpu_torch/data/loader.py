"""The host data loader (the port's own copy of ``ab_opt_tpu/data/loader.py``):
a thread-prefetched iterator of collated numpy batches, with an optional
process pool. ``num_workers=0`` fetches and transforms in the prefetch
thread; ``num_workers>0`` fans each item's fetch and transform out to
worker processes, for when the per-item O(L^2) transform work
(PatchAroundAnchor's distance matrices) would otherwise keep the device
waiting. Every item is drawn from ``(seed, idx, epoch, attempt)`` and
every shuffle from ``numpy.random.default_rng(seed)``, so the stream does
not depend on the workers and equals the JAX package's for the same seed.

With ``shard=(rank, ranks)`` a data-parallel rank collates the global batch
(the same shuffle seed on every rank) and keeps its rows of it
(``parallel/distributed.py::host_batch_slice``): padding follows the
longest item of the global batch, as on one device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..parallel.distributed import Mesh, host_batch_slice, take_rows
from .transforms import DISTVIOLATION

_worker_state: dict = {}


def _pool_init(dataset, seed):
    _worker_state['dataset'] = dataset
    _worker_state['seed'] = seed


def _fetch_with_resample(ds, idx: int, epoch: int, seed: int,
                         max_retries: int = 32):
    """Safe getitem: DISTVIOLATION resamples a neighbor (sabdab.py:502-512).

    Fully deterministic in (seed, idx, epoch). For datasets implementing the
    ``get(idx, (epoch, attempt))`` protocol (all of this package's dataset
    classes), the salt varies the transform rng per epoch AND per retry, so
    a rejected crop retries with fresh randomness even on a 1-item dataset.
    Plain sequences without ``get`` are assumed static (no internal
    randomness): retries only help via the neighbor hop, and a stochastic
    ``__getitem__`` would repeat its crop — implement ``get`` in that case.
    """
    rng = np.random.default_rng((seed, idx, epoch))
    n = len(ds)
    for attempt in range(max_retries):
        try:
            if hasattr(ds, 'get'):
                item = ds.get(idx, (epoch, attempt))
            else:
                item = ds[idx]
        except DISTVIOLATION:
            item = None
        if item is not None:
            return item
        idx = (idx + int(rng.integers(1, 16))) % n
    raise RuntimeError('Too many consecutive data violations.')


def _pool_fetch(args):
    """Worker-side fetch; (idx, epoch) comes from the parent loader."""
    idx, epoch = args
    return _fetch_with_resample(_worker_state['dataset'], idx, epoch,
                                _worker_state['seed'])


class DataLoader:
    def __init__(self, dataset: Sequence, batch_size: int,
                 collate_fn: Callable, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0,
                 prefetch: int = 2, num_workers: int = 0,
                 pad_partial: bool = False, shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        # pad_partial: fill a trailing short batch by wrapping around to the
        # start of the epoch order, so every batch has the full batch_size
        # (the training CLI's loader, as the JAX package's).
        self.pad_partial = pad_partial
        # shard: (rank, ranks); each collated batch is cut to this rank's
        # rows (batch_size must divide over the ranks).
        self.shard = shard
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.num_workers = int(num_workers)
        self._pool = None
        self._seed = seed
        self._epoch = 0

    def _get_pool(self):
        if self._pool is None:
            import multiprocessing
            # forkserver: workers fork from a clean server process, not from
            # this one, which runs threads (torch's, the prefetch thread):
            # fork here can deadlock. The dataset must be picklable (numpy
            # arrays and transforms, no tensors).
            ctx = multiprocessing.get_context('forkserver')
            self._pool = ctx.Pool(self.num_workers, initializer=_pool_init,
                                  initargs=(self.dataset, self._seed))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def skip_epoch(self):
        """Spend one epoch, and its shuffle, without fetching an item."""
        self._epoch += 1
        if self.shuffle:
            self.rng.shuffle(np.arange(len(self.dataset)))

    def _batches(self) -> Iterator:
        epoch = self._epoch
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for lo in range(0, len(order), self.batch_size):
            idxs = order[lo:lo + self.batch_size]
            if len(idxs) < self.batch_size:
                if self.drop_last:
                    break
                if self.pad_partial:
                    fill = np.resize(order, self.batch_size - len(idxs))
                    idxs = np.concatenate([idxs, fill])
            if self.num_workers > 0:
                items = self._get_pool().map(
                    _pool_fetch, [(int(i), epoch) for i in idxs])
            else:
                items = [_fetch_with_resample(self.dataset, int(i), epoch,
                                              self._seed) for i in idxs]
            batch = self.collate_fn(items)
            if self.shard is not None:
                rank, ranks = self.shard
                batch = take_rows(batch, host_batch_slice(
                    len(items), Mesh(ranks, rank)))
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error_holder = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:     # surfaced in the consumer
                error_holder.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if error_holder:
            raise error_holder[0]


def inf_iterator(loader: DataLoader) -> Iterator:
    """Endless epoch cycling."""
    while True:
        yield from loader


class TransformedDataset:
    """Apply a transform pipeline per item with per-item deterministic rng.

    Augmentation randomness is keyed by (seed, idx, salt): the DataLoader
    passes (epoch, attempt) as the salt via :meth:`get`, so the stream is
    identical run-to-run regardless of which pool worker serves which index
    (worker-local state would differ with pool scheduling). Bare
    ``dataset[idx]`` keys by (seed, idx, 0, 0).
    """

    def __init__(self, items: Sequence, transform: Optional[Callable],
                 seed: int = 0):
        self.items = items
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return len(self.items)

    def get(self, idx: int, salt: tuple = (0, 0)):
        import copy
        item = self.items[idx]
        if item is None:
            return None
        if self.transform is None:
            return item
        rng = np.random.default_rng((self.seed, idx) + tuple(salt))
        return self.transform(copy.deepcopy(item), rng=rng)

    def __getitem__(self, idx: int):
        return self.get(idx)
