"""``GruStreamBatcher`` (alias ``DeltaStreamBatcher``) — admission/harvest
scheduling of streaming requests over
:class:`~repro_torch.serve.engine.DeltaStreamEngine` stream sessions, the
PyTorch port of :class:`repro.serve.scheduler.GruStreamBatcher`.

Queued requests are admitted into free ``n_streams`` slots via
``open_stream()`` (per-slot masked reset); every tick feeds one frame per
active stream through ONE batched engine step (one weight fetch serves all
streams); exhausted streams are harvested via ``close_stream()``, which
returns that stream's own firing/latency accounting.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.serve.engine import DeltaStreamEngine


@dataclass
class StreamRequest:
    """A queued streaming inference request: a finite frame sequence."""

    uid: int
    frames: np.ndarray                       # [T, I]
    outputs: list = field(default_factory=list)
    stats: dict | None = None                # per-stream engine accounting
    done: bool = False
    cursor: int = 0
    # the sequence held non-finite frames and was submitted with
    # on_nonfinite="quarantine"
    suspect: bool = False


class GruStreamBatcher:
    """Admission/harvest scheduler over ``DeltaStreamEngine`` sessions.

    ``submit()`` queues a frame sequence; each :meth:`step` tick admits
    queued requests into free slots, feeds one frame per active stream
    through one batched engine step, and harvests exhausted streams
    (``req.stats`` gets their accounting). Idle slots are fed their last
    frame (zero delta — the silent regime).
    """

    def __init__(self, engine: DeltaStreamEngine):
        self.engine = engine
        self.queue: collections.deque[StreamRequest] = collections.deque()
        self.slots: list[StreamRequest | None] = [None] * engine.n_streams
        self._uid = itertools.count()
        self._idle_x = np.zeros((engine.n_streams, engine.dims.input_size),
                                np.float32)
        self.counters = {"submitted": 0, "admitted": 0, "harvested": 0,
                         "ticks": 0}

    # -- observability hooks ----------------------------------------------

    def queue_depth(self) -> int:
        """Requests admitted to the batcher but not yet in a slot."""
        return len(self.queue)

    def active_slots(self) -> int:
        """Stream slots currently carrying an in-flight request."""
        return sum(1 for r in self.slots if r is not None)

    def free_slots(self) -> int:
        """Engine slots not in flight, minus queued requests that will
        claim them first."""
        return max(0, self.engine.n_streams - self.active_slots()
                   - len(self.queue))

    def submit(self, frames, on_nonfinite: str = "reject") -> int:
        """Queue a ``[T, I]`` (T >= 1) frame sequence; returns its uid.

        ``on_nonfinite``: ``"reject"`` (default) raises on NaN/Inf frames;
        ``"quarantine"`` admits and tags ``req.suspect``; ``"allow"``
        admits untagged (the engine's frame guard still masks them).
        """
        if on_nonfinite not in ("reject", "quarantine", "allow"):
            raise ValueError(f"on_nonfinite={on_nonfinite!r} not in "
                             "('reject', 'quarantine', 'allow')")
        frames = np.asarray(frames, np.float32)
        if (frames.ndim != 2 or frames.shape[0] == 0
                or frames.shape[-1] != self.engine.dims.input_size):
            raise ValueError(
                f"frames must be [T >= 1, {self.engine.dims.input_size}], "
                f"got {frames.shape}")
        suspect = bool(not np.isfinite(frames).all())
        if suspect and on_nonfinite == "reject":
            raise ValueError(
                "frame sequence contains non-finite values; sanitize it, "
                "or submit with on_nonfinite='quarantine'/'allow'")
        uid = next(self._uid)
        self.queue.append(StreamRequest(
            uid, frames, suspect=suspect and on_nonfinite == "quarantine"))
        self.counters["submitted"] += 1
        return uid

    def _admit(self):
        while self.queue and self.engine.free_streams:
            req = self.queue.popleft()
            sid = self.engine.open_stream()
            self.slots[sid] = req
            self.counters["admitted"] += 1

    def step(self) -> list[StreamRequest]:
        """One tick: admit, one batched engine step, harvest. Returns the
        finished requests (with ``stats`` filled).

        Per-frame outputs stay device slices until their stream finishes
        (harvest decisions are cursor-based, never value-based), so a tick
        that harvests nothing does not synchronise the host.
        """
        self._admit()
        self.counters["ticks"] += 1
        active = [(sid, req) for sid, req in enumerate(self.slots)
                  if req is not None]
        if not active:
            return []
        x = self._idle_x
        for sid, req in active:
            x[sid] = req.frames[req.cursor]
        # the engine snapshots the host buffer before the step is queued,
        # so the next tick may overwrite it
        out = self.engine.step(x).reshape(self.engine.n_streams, -1)
        finished = []
        host_carry = None
        for sid, req in active:
            req.outputs.append(out[sid])         # device slice, no sync
            req.cursor += 1
            if req.cursor >= len(req.frames):
                if host_carry is None:           # one sync per tick, shared
                    host_carry = self.engine.host_carry()
                req.stats = self.engine.close_stream(sid,
                                                     host_carry=host_carry)
                req.outputs = list(torch.stack(req.outputs).cpu().numpy())
                req.done = True
                finished.append(req)
                self.slots[sid] = None
        self.counters["harvested"] += len(finished)
        return finished

    def run_until_drained(self, max_ticks: int = 100000,
                          strict: bool = True):
        """Tick until queue and slots are empty; returns finished requests.
        ``strict`` raises ``RuntimeError`` if the tick budget runs out with
        work still queued or in flight."""
        done = []
        for _ in range(max_ticks):
            done += self.step()
            if not self.queue and not any(r is not None for r in self.slots):
                return done
        in_flight = sum(r is not None for r in self.slots)
        if strict and (self.queue or in_flight):
            raise RuntimeError(
                f"run_until_drained truncated at max_ticks={max_ticks}: "
                f"{len(self.queue)} queued + {in_flight} in-flight "
                f"requests undrained ({len(done)} finished); raise "
                "max_ticks or pass strict=False for a partial result")
        return done


# The name of the cell-agnostic scheduler in the JAX package.
DeltaStreamBatcher = GruStreamBatcher
