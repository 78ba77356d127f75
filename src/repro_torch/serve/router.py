"""Async request router: one front door for a sharded serving fleet, the
PyTorch port of :mod:`repro.serve.router`.

:class:`StreamRouter` fronts N shard workers with bounded per-shard
queues, join-shortest-queue placement, and the engine tier's admission
semantics (reject on a full queue, shed queued requests that out-wait
their tick deadline). Two worker flavors:

* **fabric mode** — the shards are a
  :class:`repro_torch.dist.serving.ShardedStreamFleet`: every router tick
  stages one frame per in-flight stream into a single ``[N, I]`` buffer
  and issues ONE fleet step for the whole fleet (a graph replay a shard
  on the card). A stream's per-tick outputs stay rows of the tick's
  device output until it finishes, so a tick on which no stream finishes
  does not synchronise the host; a harvest tick reads the carry once
  (``fleet.host_carry()``) and copies the finished streams' outputs to
  the host in one copy. This is the distributed serving fabric.
* **pool mode** — the shards are a list of
  :class:`~repro_torch.serve.scheduler.DeltaStreamBatcher` /
  :class:`~repro_torch.serve.resilience.ResilientStreamServer` workers
  (one engine each); each tick steps every worker. Same router semantics,
  useful when shards are separate engines rather than one mesh.

Accounting runs as **two books that must agree**: the router's own
per-shard + fleet-wide event counts (submitted / completed / rejected /
shed / queued / in-flight — exact integers, conserved at every tick:
``submitted == completed + rejected + shed + quarantined + queued +
in_flight``), and the engines' lifetime aggregates underneath (the
per-shard ``frames_out`` book equals the sum of harvested per-stream
``steps`` bitwise — the router never loses a frame the engine executed).

Elastic rebalance (fabric mode): :meth:`scale_down` drain-checkpoints
the dying shard through the fleet (``engine.checkpoint``), drops it from
the mesh, remaps surviving slots, and **replays the dead shard's
queued + in-flight streams from frame 0** onto the survivors via the
normal JSQ path — recurrent replay is deterministic, so replayed streams
complete bitwise identical to a clean run (the chaos invariant the
load-generator gates).

The router is deliberately wall-clock-free in its decisions: placement,
admission, shedding, and rebalance all count ticks, so a seeded load run
reproduces its entire event history exactly on any machine, and equal to
the JAX package's. Wall time is only *measured* (per-tick, for the
latency gates).
"""
from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.serve.resilience import ResilientStreamServer
from repro_torch.serve.scheduler import DeltaStreamBatcher

__all__ = ["StreamRouter", "RouterPolicy", "RouterResult"]


@dataclass
class RouterPolicy:
    """Router knobs. Limits are in ticks (deterministic), never wall."""

    max_queue: int = 64                 # per-shard queue bound (reject)
    deadline_ticks: int | None = None   # shed QUEUED requests older than
    on_nonfinite: str = "reject"        # admission default for poison


@dataclass
class RouterResult:
    """Terminal outcome of one routed stream (mirrors ``ServeResult``)."""

    uid: int
    shard: int
    status: str                         # ok | rejected | shed | quarantined
    outputs: list | None = None
    stats: dict | None = None
    error: dict | None = None
    submit_tick: int = 0
    done_tick: int = 0
    replayed: bool = False              # finished after an elastic replay
    submit_wall: float = 0.0
    done_wall: float = 0.0

    @property
    def latency_ticks(self) -> int:
        """Admission-to-harvest latency in router ticks (deterministic;
        replayed streams keep their ORIGINAL submit tick, so the rebalance
        cost is visible in the latency distribution, not hidden)."""
        return self.done_tick - self.submit_tick


@dataclass
class _Routed:
    uid: int
    frames: np.ndarray
    shard: int
    cursor: int = 0
    outputs: list = field(default_factory=list)
    suspect: bool = False
    replayed: bool = False
    submit_tick: int = 0
    submit_wall: float = 0.0


def _book() -> dict:
    return {"submitted": 0, "completed": 0, "rejected": 0, "shed": 0,
            "quarantined": 0, "replayed_in": 0, "frames_out": 0,
            "harvested_steps": 0}


class _BatcherPort:
    """Pool-mode adapter: one ``DeltaStreamBatcher`` worker."""

    def __init__(self, worker: DeltaStreamBatcher):
        self.worker = worker
        self._uid2rec: dict[int, _Routed] = {}

    def free_slots(self) -> int:
        return self.worker.free_slots()

    def active_count(self) -> int:
        return self.worker.active_slots() + self.worker.queue_depth()

    def push(self, rec: _Routed) -> list:
        uid = self.worker.submit(rec.frames, on_nonfinite="allow")
        self._uid2rec[uid] = rec
        return []

    def step(self) -> list:
        out = []
        for req in self.worker.step():
            rec = self._uid2rec.pop(req.uid)
            out.append((rec, "ok", req.outputs, req.stats, None))
        return out


class _ResilientPort:
    """Pool-mode adapter: one supervised ``ResilientStreamServer``.

    The worker's own policy still runs (quarantine, overload-Θ, its own
    deadline/queue bounds) — its terminal statuses pass through to the
    router books, so the conservation law spans both layers.
    """

    def __init__(self, worker: ResilientStreamServer):
        self.worker = worker
        self._uid2rec: dict[int, _Routed] = {}

    def free_slots(self) -> int:
        return self.worker.free_slots()

    def active_count(self) -> int:
        return self.worker.active_slots() + self.worker.queue_depth()

    def push(self, rec: _Routed) -> list:
        uid, admitted = self.worker.submit(
            rec.frames,
            on_nonfinite="quarantine" if rec.suspect else "allow")
        if not admitted:
            res = self.worker.results[-1]
            return [(rec, res.status, res.outputs, res.stats, res.error)]
        self._uid2rec[uid] = rec
        return []

    def step(self) -> list:
        out = []
        for res in self.worker.tick():
            rec = self._uid2rec.pop(res.uid, None)
            if rec is None:              # e.g. duplicate terminal; ignore
                continue
            out.append((rec, res.status, res.outputs, res.stats, res.error))
        return out


class StreamRouter:
    """JSQ router over a sharded fleet or a pool of engine workers.

    ``shards`` is either a
    :class:`~repro_torch.dist.serving.ShardedStreamFleet`
    (fabric mode) or a sequence of ``DeltaStreamBatcher`` /
    ``ResilientStreamServer`` workers (pool mode).
    """

    def __init__(self, shards, policy: RouterPolicy | None = None):
        self.policy = policy or RouterPolicy()
        if self.policy.on_nonfinite not in ("reject", "quarantine", "allow"):
            raise ValueError(
                f"on_nonfinite={self.policy.on_nonfinite!r} not in "
                "('reject', 'quarantine', 'allow')")
        # fabric mode is duck-typed (streams_per_shard + open_stream) so
        # this module never imports repro_torch.dist at import time
        if hasattr(shards, "streams_per_shard") and hasattr(shards,
                                                            "open_stream"):
            self.fleet = shards
            self.ports = None
            self._slot_rec: dict[int, _Routed] = {}
            self._buf = np.zeros(
                (self.fleet.n_streams, self.fleet.dims.input_size),
                np.float32)
        else:
            workers = list(shards)
            if not workers:
                raise ValueError("pool mode needs at least one worker")
            self.fleet = None
            self.ports = []
            for w in workers:
                if isinstance(w, ResilientStreamServer):
                    self.ports.append(_ResilientPort(w))
                elif isinstance(w, DeltaStreamBatcher):
                    self.ports.append(_BatcherPort(w))
                else:
                    raise TypeError(
                        f"worker {type(w).__name__} is not a "
                        "DeltaStreamBatcher / ResilientStreamServer / "
                        "ShardedStreamFleet")
        n = self.n_shards
        self.queues: list[collections.deque] = [collections.deque()
                                                for _ in range(n)]
        self.books: list[dict] = [_book() for _ in range(n)]
        self.retired_books: list[dict] = []
        self.totals = _book()
        self.totals["rebalanced"] = 0
        self.tick_no = 0
        self.tick_wall_s: list[float] = []
        self._uid = itertools.count()
        self._input_size = (self.fleet.dims.input_size if self.fleet
                            else self.ports[0].worker.engine.dims.input_size)
        self.results: list[RouterResult] = []

    # -- observability ----------------------------------------------------

    @property
    def n_shards(self) -> int:
        return (self.fleet.n_shards if self.fleet is not None
                else len(self.ports))

    def queue_depth(self, shard: int | None = None) -> int:
        if shard is not None:
            return len(self.queues[shard])
        return sum(len(q) for q in self.queues)

    def active_slots(self, shard: int | None = None) -> int:
        if self.fleet is not None:
            return self.fleet.active_slots(shard)
        ports = self.ports if shard is None else [self.ports[shard]]
        return sum(p.active_count() for p in ports)

    def in_flight(self) -> int:
        if self.fleet is not None:
            return len(self._slot_rec)
        return sum(len(p._uid2rec) for p in self.ports)

    def idle(self) -> bool:
        return self.queue_depth() == 0 and self.in_flight() == 0

    # -- admission --------------------------------------------------------

    def _shard_load(self, s: int) -> int:
        return len(self.queues[s]) + (
            self.fleet.active_slots(s) if self.fleet is not None
            else self.ports[s].active_count())

    def _place(self) -> int:
        """Join-shortest-queue: least outstanding work, shard id breaks
        ties — fully deterministic."""
        return min(range(self.n_shards), key=lambda s: (self._shard_load(s),
                                                        s))

    def submit(self, frames, on_nonfinite: str | None = None
               ) -> tuple[int, bool]:
        """Route one ``[T, I]`` stream. Returns ``(uid, admitted)``; a
        rejection is also recorded as a terminal :class:`RouterResult`, so
        every uid has exactly one outcome (the conservation law)."""
        on_nonfinite = on_nonfinite or self.policy.on_nonfinite
        frames = np.asarray(frames, np.float32)
        if (frames.ndim != 2 or frames.shape[0] == 0
                or frames.shape[-1] != self._input_size):
            raise ValueError(
                f"frames must be [T >= 1, {self._input_size}], got "
                f"{frames.shape}")
        suspect = bool(not np.isfinite(frames).all())
        if suspect and on_nonfinite == "reject":
            raise ValueError(
                "frame sequence contains non-finite values; sanitize "
                "(serve.faults.sanitize_frames) or submit with "
                "on_nonfinite='quarantine'/'allow'")
        uid = next(self._uid)
        s = self._place()
        now = time.perf_counter()
        self.totals["submitted"] += 1
        self.books[s]["submitted"] += 1
        if len(self.queues[s]) >= self.policy.max_queue:
            # JSQ picked the least-loaded shard, so every queue is at the
            # bound: fleet-wide backpressure, attributed to the chosen
            # shard (deterministically) for the per-shard book
            res = RouterResult(
                uid, s, "rejected",
                error={"reason": "queue_full", "shard": s,
                       "depth": len(self.queues[s]),
                       "max_queue": self.policy.max_queue},
                submit_tick=self.tick_no, done_tick=self.tick_no,
                submit_wall=now, done_wall=now)
            self.books[s]["rejected"] += 1
            self.totals["rejected"] += 1
            self.results.append(res)
            return uid, False
        self.queues[s].append(_Routed(
            uid, frames, s,
            suspect=suspect and on_nonfinite == "quarantine",
            submit_tick=self.tick_no, submit_wall=now))
        return uid, True

    # -- the tick ---------------------------------------------------------

    def _account(self, rec: _Routed, status: str, stats=None
                 ) -> None:
        key = {"ok": "completed"}.get(status, status)
        if key not in self.totals:
            key = "completed"
        self.totals[key] += 1
        self.books[rec.shard][key] += 1
        if status == "ok":
            self.books[rec.shard]["frames_out"] += len(rec.frames)
            self.totals["frames_out"] += len(rec.frames)
            if stats is not None:
                n = int(round(stats["steps"]))
                self.books[rec.shard]["harvested_steps"] += n
                self.totals["harvested_steps"] += n

    def _package(self, rec: _Routed, status: str, outputs=None, stats=None,
                 error=None) -> RouterResult:
        res = RouterResult(
            rec.uid, rec.shard, status, outputs=outputs, stats=stats,
            error=error, submit_tick=rec.submit_tick,
            done_tick=self.tick_no, replayed=rec.replayed,
            submit_wall=rec.submit_wall, done_wall=time.perf_counter())
        self._account(rec, status, stats=stats)
        self.results.append(res)
        return res

    def tick(self) -> list[RouterResult]:
        """One fabric tick: shed → admit → step → harvest. Returns the
        streams that reached a terminal status this tick."""
        t0 = time.perf_counter()
        out = []
        # 1. shed queued requests past their tick deadline. Replayed
        # streams are exempt: they already paid their queue wait once and
        # the rebalance contract promises completion on a survivor.
        p = self.policy
        if p.deadline_ticks is not None:
            for s, q in enumerate(self.queues):
                if not q:
                    continue
                keep: collections.deque = collections.deque()
                for rec in q:
                    waited = self.tick_no - rec.submit_tick
                    if waited >= p.deadline_ticks and not rec.replayed:
                        out.append(self._package(rec, "shed", error={
                            "reason": "deadline", "queued_ticks": waited,
                            "deadline_ticks": p.deadline_ticks}))
                    else:
                        keep.append(rec)
                self.queues[s] = keep
        if self.fleet is not None:
            out += self._tick_fabric()
        else:
            out += self._tick_pool()
        self.tick_no += 1
        self.tick_wall_s.append(time.perf_counter() - t0)
        return out

    def _tick_fabric(self) -> list[RouterResult]:
        fleet = self.fleet
        # 2. admit queued streams into free shard slots
        for s, q in enumerate(self.queues):
            while q and fleet.free_streams(s):
                rec = q.popleft()
                sid = fleet.open_stream(s)
                self._slot_rec[sid] = rec
        active = sorted(self._slot_rec.items())
        if not active:
            return []
        # 3. stage one frame per in-flight stream; idle slots keep their
        # previous frame (zero delta — the silent regime)
        for sid, rec in active:
            self._buf[sid] = rec.frames[rec.cursor]
        # ONE fleet step for the whole fleet (fleet.step snapshots the
        # buffer with a synchronous copy — see engine.step's aliasing note)
        y = fleet.step(self._buf)
        # 4. harvest: each stream keeps its row of the tick's output on the
        # device; a stream that finishes is read with the others finishing
        # this tick, in one carry read and one copy of their outputs
        finished = []
        for sid, rec in active:
            rec.outputs.append(y[sid])
            rec.cursor += 1
            if rec.cursor >= len(rec.frames):
                finished.append((sid, rec))
        if not finished:
            return []
        host_carry = fleet.host_carry()
        flat = torch.stack([o for _, rec in finished
                            for o in rec.outputs]).cpu().numpy()
        out = []
        off = 0
        for sid, rec in finished:
            outputs = list(flat[off:off + len(rec.outputs)])
            off += len(rec.outputs)
            stats = fleet.close_stream(sid, host_carry=host_carry)
            del self._slot_rec[sid]
            out.append(self._package(rec, "ok", outputs=outputs,
                                     stats=stats))
        return out

    def _tick_pool(self) -> list[RouterResult]:
        out = []
        for s, port in enumerate(self.ports):
            q = self.queues[s]
            while q and port.free_slots() > 0:
                rec = q.popleft()
                for rec2, status, outputs, stats, error in port.push(rec):
                    out.append(self._package(rec2, status, outputs=outputs,
                                             stats=stats, error=error))
        for port in self.ports:
            for rec, status, outputs, stats, error in port.step():
                out.append(self._package(rec, status, outputs=outputs,
                                         stats=stats, error=error))
        return out

    def run_until_drained(self, max_ticks: int = 100000
                          ) -> list[RouterResult]:
        """Tick until no work is queued or in flight (strict)."""
        done: list[RouterResult] = []
        for _ in range(max_ticks):
            done += self.tick()
            if self.idle():
                return done
        raise RuntimeError(
            f"router drain truncated at max_ticks={max_ticks}: "
            f"{self.queue_depth()} queued + {self.in_flight()} in flight")

    # -- elastic rebalance (fabric mode) ----------------------------------

    def scale_down(self, dead_shard: int, ckpt_dir: str | None = None
                   ) -> dict:
        """Simulated device loss on ``dead_shard``.

        Drain-checkpoints the dying shard (when ``ckpt_dir`` is given),
        removes it from the fleet's mesh (survivors keep their exact
        bits — same per-device tile width), remaps surviving slot ids,
        and replays the dead shard's queued + in-flight streams FROM
        FRAME 0 onto the survivors through the normal JSQ path.
        Deterministic replay makes the replayed streams' outputs bitwise
        identical to a clean run — the chaos invariant.
        """
        if self.fleet is None:
            raise RuntimeError("scale_down is fabric-mode only (a pool "
                               "worker dying is just a smaller pool)")
        if self.n_shards <= 1:
            raise ValueError("cannot scale below one shard (a zero-shard "
                             "fleet is a full outage, not a resize)")
        b = self.fleet.streams_per_shard
        displaced = list(self.queues[dead_shard])
        dead_slots = [sid for sid in self._slot_rec
                      if self.fleet.shard_of(sid) == dead_shard]
        displaced += [self._slot_rec.pop(sid) for sid in sorted(dead_slots)]
        # survivors' accumulated outputs are rows of earlier ticks' outputs,
        # tensors of their own: the remesh leaves them valid as they are
        info = self.fleet.remove_shard(dead_shard, ckpt_dir=ckpt_dir)
        # remap the survivors' router-side bookkeeping
        sid_map = info["sid_map"]
        self._slot_rec = {sid_map[sid]: rec
                          for sid, rec in self._slot_rec.items()}
        dead_rows = np.arange(dead_shard * b, (dead_shard + 1) * b)
        self._buf = np.delete(self._buf, dead_rows, axis=0)
        self.queues.pop(dead_shard)
        retired = self.books.pop(dead_shard)
        retired["shard"] = dead_shard
        self.retired_books.append(retired)
        for rec in self._slot_rec.values():
            if rec.shard > dead_shard:
                rec.shard -= 1
        for s, q in enumerate(self.queues):
            for rec in q:
                rec.shard = s
        # replay the displaced from frame 0 on survivors (JSQ placement);
        # their uids and submit ticks are preserved — the rebalance is
        # invisible in the books except through the latency distribution
        # and the `rebalanced` counter
        for rec in displaced:
            rec.cursor = 0
            rec.outputs = []
            rec.replayed = True
            s = self._place()
            rec.shard = s
            self.queues[s].append(rec)
            self.books[s]["replayed_in"] += 1
        self.totals["rebalanced"] += len(displaced)
        info["replayed"] = len(displaced)
        return info

    # -- reporting --------------------------------------------------------

    def conservation(self) -> dict:
        """The router book's conservation law as exact integers."""
        t = self.totals
        outstanding = self.queue_depth() + self.in_flight()
        accounted = (t["completed"] + t["rejected"] + t["shed"]
                     + t["quarantined"] + outstanding)
        return {
            "submitted": t["submitted"],
            "completed": t["completed"],
            "rejected": t["rejected"],
            "shed": t["shed"],
            "quarantined": t["quarantined"],
            "queued": self.queue_depth(),
            "in_flight": self.in_flight(),
            "rebalanced": t["rebalanced"],
            "conserved": t["submitted"] == accounted,
            # book two: every frame the router handed out equals a step
            # the engines executed and harvested — bitwise integers
            "frames_out": t["frames_out"],
            "harvested_steps": t["harvested_steps"],
            "frames_conserved": t["frames_out"] == t["harvested_steps"],
        }

    def report(self) -> dict:
        rep = {
            "mode": "fabric" if self.fleet is not None else "pool",
            "n_shards": self.n_shards,
            "ticks": self.tick_no,
            "conservation": self.conservation(),
            "per_shard": [dict(b, shard=s, queued=len(self.queues[s]),
                               active=self.active_slots(s))
                          for s, b in enumerate(self.books)],
            "retired_shards": [dict(b) for b in self.retired_books],
        }
        if self.fleet is not None:
            rep["fleet"] = self.fleet.report()
        return rep
