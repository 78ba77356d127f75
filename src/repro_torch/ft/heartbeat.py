"""Heartbeat-based liveness tracking, the port of :mod:`repro.ft.heartbeat`
(pure Python, the same as there).

Each worker publishes ``beat(worker_id)`` on a cadence; the monitor flags
workers whose last beat is older than ``deadline_s``. On a real cluster the
registry is a distributed KV store (etcd / coordination service); here it is
process-local but exercised by the fault-injection tests with simulated
worker threads.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass
class WorkerStatus:
    last_beat: float
    beats: int = 0
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 5.0,
                 clock=time.monotonic):
        self.deadline_s = deadline_s
        self._clock = clock
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerStatus] = {}

    def register(self, worker_id: str):
        with self._lock:
            self._workers[worker_id] = WorkerStatus(self._clock())

    def beat(self, worker_id: str):
        with self._lock:
            st = self._workers.setdefault(worker_id,
                                          WorkerStatus(self._clock()))
            st.last_beat = self._clock()
            st.beats += 1
            st.alive = True

    def check(self) -> dict[str, bool]:
        """worker_id -> alive?; marks and returns current liveness."""
        now = self._clock()
        with self._lock:
            for st in self._workers.values():
                st.alive = (now - st.last_beat) <= self.deadline_s
            return {w: st.alive for w, st in self._workers.items()}

    def dead_workers(self) -> list[str]:
        return [w for w, ok in self.check().items() if not ok]

    def age(self, worker_id: str) -> float:
        """Seconds since ``worker_id``'s last beat (raises if unknown)."""
        with self._lock:
            return self._clock() - self._workers[worker_id].last_beat

    @property
    def all_alive(self) -> bool:
        return not self.dead_workers()
