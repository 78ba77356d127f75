"""Request schedulers over the serving engines' fixed slot counts, the
PyTorch port of :mod:`repro.serve.scheduler`.

``ContinuousBatcher`` — continuous batching over ``LmEngine`` decode slots:
whenever slots free up, the newest wave of queued prompts is left-padded to
a common length and prefilled through the whole-batch prefill (which
attends over the pads, as the reference does); the live slots' cache rows
are merged back, in place, from a copy taken before the wave, so in-flight
requests are untouched. On a CUDA device the prefill is one graph replay,
and each distinct wave length captures its graph once (lengths are not
bucketed: a longer pad is another prompt, with another result); the copy
and the merge run eagerly, as the reference jits neither. Every tick
decodes all slots; finished slots (EOS or budget) are harvested and
recycled.

``GruStreamBatcher`` (alias ``DeltaStreamBatcher``) — admission/harvest
scheduling of streaming requests over
:class:`~repro_torch.serve.engine.DeltaStreamEngine` stream sessions.

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

from repro_torch.models.common import tree_map
from repro_torch.serve.engine import DeltaStreamEngine, LmEngine


@dataclass
class Request:
    uid: int
    prompt: list
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based scheduler. Admission prefills the incoming wave through
    the batch prefill and then restores the live slots' cache rows:
    prefill writes every slot's cache, so without the slotwise merge an
    admission into a partly occupied batch would corrupt the in-flight
    requests. The engine writes its caches in place (its captured prefill
    and decode graphs read and write those buffers), so the rows kept are
    a copy taken before the wave, and the merge writes into the caches."""

    def __init__(self, engine: LmEngine, pad_id: int = 0):
        self.engine = engine
        self.pad_id = pad_id
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Request | None] = [None] * engine.batch
        self._uid = itertools.count()
        self._last_tokens = np.zeros((engine.batch, 1), np.int32)

    def submit(self, prompt: list, max_new_tokens: int = 16,
               eos_id: int | None = None) -> int:
        uid = next(self._uid)
        self.queue.append(Request(uid, list(prompt), max_new_tokens, eos_id))
        return uid

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not free or not self.queue:
            return
        wave = []
        for slot in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            self.slots[slot] = req
            wave.append((slot, req))
        # the live slots get a pad-only "prompt" whose cache writes are
        # garbage: keep a copy of their rows and merge them back after
        old_caches = (tree_map(torch.clone, self.engine.caches) if live
                      else None)
        max_len = max(len(r.prompt) for _, r in wave)
        tokens = np.full((self.engine.batch, max_len), self.pad_id, np.int32)
        for slot, req in wave:
            tokens[slot, -len(req.prompt):] = req.prompt
        logits = self.engine.prefill(tokens)
        if live:
            keep = np.zeros((self.engine.batch,), bool)
            keep[live] = True
            # in place: the engine's captured decode step reads its caches
            _merge_caches_slotwise(
                old_caches, self.engine.caches,
                torch.from_numpy(keep).to(self.engine.device))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for slot, req in wave:
            req.output.append(int(nxt[slot]))
            self._last_tokens[slot, 0] = int(nxt[slot])

    def step(self) -> list[Request]:
        """One scheduler tick: admit, decode, harvest. Returns the requests
        that finished."""
        self._admit()
        if not any(self.slots):
            return []
        logits = self.engine.decode_step(self._last_tokens)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.output.append(tok)
            self._last_tokens[i, 0] = tok
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.output) >= req.max_new_tokens):
                req.done = True
                finished.append(req)
                self.slots[i] = None
        return finished

    def run_until_drained(self, max_ticks: int = 1000,
                          strict: bool = True) -> list[Request]:
        """Tick until queue and slots are empty; returns the finished
        requests. With ``strict`` (the default) an exhausted tick budget
        raises ``RuntimeError``; ``strict=False`` returns what finished."""
        done = []
        for _ in range(max_ticks):
            done += self.step()
            if not self.queue and not any(self.slots):
                return done
        if strict and (self.queue or any(self.slots)):
            raise RuntimeError(
                f"run_until_drained truncated at max_ticks={max_ticks}: "
                f"{len(self.queue)} queued + "
                f"{sum(s is not None for s in self.slots)} in-flight "
                f"requests undrained ({len(done)} finished); raise "
                "max_ticks or pass strict=False for a partial result")
        return done


def _merge_caches_slotwise(old, new, keep: torch.Tensor):
    """``old``'s rows for the slots where ``keep`` is True, else ``new``'s,
    written into ``new`` in place (its leaves keep their buffers); returns
    ``new``. Cache leaves are stacked ``[count, B, ...]``
    (:func:`repro_torch.models.blocks.init_caches`): the slot is axis 1."""
    def sel(o, n):
        return torch.where(keep.reshape((1, -1) + (1,) * (n.ndim - 2)), o, n,
                           out=n)

    tree_map(sel, old, new)
    return new


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
