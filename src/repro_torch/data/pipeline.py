"""Host-side data pipeline: background prefetch and mesh placement, the
PyTorch port of :mod:`repro.data.pipeline`.

``shard_batch`` puts each leaf of a batch on the mesh with the reference's
spec (the batch dim on the ``batch`` axes, the rest replicated); the port's
mesh lists one device, so a leaf lies whole on it and carries its spec as
``.sharding``. ``prefetch_to_mesh`` is that placement behind a
``Prefetcher``, the launcher's input pipeline.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

from repro_torch.dist.elastic import Mesh
from repro_torch.dist.sharding import AxisRules, NamedSharding, device_put
from repro_torch.train.optim import tree_map


class Prefetcher:
    """Wrap a batch iterator with an N-deep background prefetch queue.

    A worker thread pulls ``it`` ahead of the consumer, at most ``depth``
    items ahead; items come out in order. An exception in the worker ends
    the stream and is raised on the consumer's side, at the ``next`` that
    would have returned the item. After ``close`` the worker stops at the
    next item it pulls: the consumer reads what is queued, then
    ``StopIteration``. The worker is a daemon thread; one left waiting on
    a full queue holds at most ``depth + 1`` items."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._done = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._done.is_set():
                        return
                    self._q.put(item)
            except Exception as e:  # surface errors on the consumer side
                self._err = e
            finally:
                self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._done.set()


def shard_batch(batch, mesh: Mesh, rules: AxisRules | None = None):
    """Place a batch (a tree of ``[B, ...]`` tensors) on the mesh: each
    leaf's spec is the batch dim on the ``batch`` axes and the rest
    replicated, as the reference resolves it, and the leaf goes to the
    mesh's device (``device_put``)."""
    rules = rules or AxisRules()

    def sharding(x):
        spec = rules.resolve(*(["batch"] + [None] * (x.ndim - 1)), mesh=mesh)
        return NamedSharding(mesh, spec)

    return device_put(batch, tree_map(sharding, batch))


def prefetch_to_mesh(it: Iterator, mesh: Mesh,
                     rules: AxisRules | None = None, depth: int = 2):
    """Prefetch + shard: the standard input pipeline composition."""
    return Prefetcher((shard_batch(b, mesh, rules) for b in it), depth=depth)
