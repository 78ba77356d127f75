"""Host-side data pipeline: background prefetch, the PyTorch port of
:class:`repro.data.pipeline.Prefetcher`.

The reference's mesh placement (``shard_batch``, ``prefetch_to_mesh``)
needs ``dist/sharding.py::AxisRules`` and waits for the port's mesh paths
(``ROADMAP.md`` Queue 1 item 5e). On one device the batch builders put a
batch where it runs (``lm_batch(..., device=...)``), so the prefetch alone
is the input pipeline.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator


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
