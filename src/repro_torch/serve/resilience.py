"""Resilient serving: a fault-tolerance supervisor over the stream
batcher, the PyTorch port of :mod:`repro.serve.resilience`.

The ft stack (:mod:`repro_torch.ft`) knows how to checkpoint atomically,
detect dead/straggling workers, and restart a loop from published state.
This module drives that machinery into the serving tier, where the failure
modes are an edge deployment's: poisoned sensor frames, corrupted recurrent
state, CPU-contention stalls, process death. Division of labor:

* the **engine** (``serve.engine.DeltaStreamEngine``) neutralizes frame
  poison on the device (no sync), carries ``poison_steps`` /
  ``bad_state`` counters, and provides slot snapshot/rollback plus
  whole-engine checkpoint/restore, all writing into the buffers its CUDA
  graph reads;
* the **supervisor** (:class:`ResilientStreamServer`) makes the policy
  calls on top: bounded-queue admission, deadline shedding, quarantine
  after K poisoned frames (rollback, then sanitize-and-resume or reject),
  state-corruption detection on a check-tick cadence (the only extra host
  sync, one :meth:`~repro_torch.serve.engine.DeltaStreamEngine.host_carry`
  read amortized over ``check_every`` ticks), overload control through
  the paper's dynamic-Θ controller, heartbeat/straggler instrumentation,
  and sidecar-consistent checkpoints;
* :func:`serve_resumable` wraps the whole loop in
  :func:`repro_torch.ft.restart.with_restarts`: a crash (e.g.
  ``serve.faults.SimulatedCrash``) restarts from the latest published
  checkpoint, replays interrupted streams from frame 0 through freshly
  reset slots (recurrent replay is deterministic, so completed outputs
  are bit-identical to an undisturbed run), and the engine's lifetime
  accounting continues EXACTLY from the checkpointed aggregates.

Every policy trigger (admission, deadlines, quarantine, overload) is
counted in TICKS, never wall time, so a seeded chaos run reproduces its
shed/quarantine/recovery counts exactly, on the CPU and on the card, and
equal to the JAX package's on the same schedule. The only wall-clock
consumers are the heartbeat/straggler instruments, whose flags are
reported but never part of exact gates.
"""
from __future__ import annotations

import collections
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.thresholds import dynamic_threshold
from repro_torch.ft import checkpoint as ft_checkpoint
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.restart import with_restarts
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.serve.engine import DeltaStreamEngine
from repro_torch.serve.faults import (SimulatedCrash, corrupt_slot_state,
                                      sanitize_frames)
from repro_torch.serve.scheduler import DeltaStreamBatcher, StreamRequest


@dataclass
class ResiliencePolicy:
    """Knobs for :class:`ResilientStreamServer`. All limits are in ticks.

    ``overload_queue`` is the queue-depth watermark for the dynamic-Θ
    overload path (None disables it): on every check tick the queue depth
    is fed to :func:`repro_torch.core.thresholds.dynamic_threshold` as the
    "firing" measurement against the watermark as target — a deeper queue
    multiplicatively raises Θ_h (cheaper steps, faster drain), a shallow
    one decays it back toward the engine's baseline Θ_h. Requires an
    engine without the in-step dynamic controller and without per-layer
    thresholds (both would fight over the same scalar).
    """

    max_queue: int = 64                 # admission bound (reject beyond)
    deadline_ticks: int | None = None   # shed QUEUED requests older than
    quarantine_after: int = 3           # K poisoned frames -> quarantine
    on_quarantine: str = "readmit"      # 'readmit' (sanitize) | 'reject'
    check_every: int = 8                # supervisor check-tick cadence
    ckpt_dir: str | None = None
    ckpt_every: int | None = None       # ticks between checkpoints
    overload_queue: int | None = None   # queue watermark for dynamic Θ
    overload_gain: float = 0.5
    theta_max: float = 0.5
    heartbeat_deadline_s: float = 5.0
    straggler_factor: float = 4.0
    straggler_patience: int = 3
    max_restarts: int = 3


@dataclass
class ServeResult:
    """Terminal outcome of one submitted stream.

    ``status``: ``"ok"`` (ran to completion — possibly after a sanitize-
    and-resume recovery, see ``error``), ``"rejected"`` (bounded queue
    full at admission), ``"shed"`` (out-waited its deadline in the
    queue), or ``"quarantined"`` (hit the poison/corruption policy with
    ``on_quarantine="reject"``; ``stats`` carries the partial session
    accounting, ``error`` the structured reason).
    """

    uid: int
    status: str
    outputs: list | None = None
    stats: dict | None = None
    error: dict | None = None


class ResilientStreamServer:
    """Policy supervisor over a :class:`DeltaStreamBatcher`.

    Per :meth:`tick` (in order): optional checkpoint (cadence), heartbeat
    beat, deadline shedding of queued requests, ONE batched engine step
    via the batcher, snapshot-baseline reconciliation for new admissions,
    host-side poison bookkeeping (the frames are host numpy already — no
    device sync), quarantine triggers, result packaging, and — on check
    ticks only — the single ``host_carry`` read that screens for state
    corruption, refreshes healthy-slot snapshots, and steers the overload
    Θ. The engine's sync-free hot loop is preserved: between check ticks
    (and harvests) nothing reads device state.
    """

    def __init__(self, batcher: DeltaStreamBatcher,
                 policy: ResiliencePolicy | None = None):
        self.batcher = batcher
        self.engine: DeltaStreamEngine = batcher.engine
        self.policy = policy or ResiliencePolicy()
        if self.policy.on_quarantine not in ("readmit", "reject"):
            raise ValueError(
                f"on_quarantine={self.policy.on_quarantine!r} not in "
                "('readmit', 'reject')")
        if self.policy.overload_queue is not None:
            if self.engine.dynamic_target is not None:
                raise ValueError(
                    "overload Θ control and the engine's in-step dynamic-Θ "
                    "controller would fight over the same scalar; disable "
                    "one")
            if self.engine._per_layer:
                raise ValueError(
                    "overload Θ control adjusts one scalar theta_h, which "
                    "would silently override per-layer thresholds")
        self.heartbeat = HeartbeatMonitor(
            deadline_s=self.policy.heartbeat_deadline_s)
        self.heartbeat.register("serve")
        self.straggler = StragglerDetector(
            factor=self.policy.straggler_factor,
            patience=self.policy.straggler_patience, policy="restart")
        self.tick_no = 0
        self.n_submitted = 0
        self.results: list[ServeResult] = []
        self.counters = {
            "completed": 0, "rejected": 0, "shed": 0,
            "quarantined": 0, "recovered": 0, "poison_frames": 0,
            "theta_raises": 0,
            # wall-clock-derived flags: reported, NEVER exact-gated
            "straggler_flags": 0, "missed_heartbeats": 0,
        }
        self.theta_peak = float(self.engine.thresholds.theta_h)
        self._theta_base = float(self.engine.thresholds.theta_h)
        self._theta_now = float(self.engine.theta_h)
        self.tick_wall_s: list[float] = []
        self.ckpt_extra = None            # callable -> dict, sidecar hook
        self._submit_tick: dict[int, int] = {}
        self._poison_seen: dict[int, int] = {}
        self._recovered: set[int] = set()
        self._slot_uid: dict[int, int] = {}
        self._snap_cursor: dict[int, int] = {}
        self._snap_nout: dict[int, int] = {}
        self._snap_bad: dict[int, float] = {}
        self._best_wall: float | None = None

    # -- observability (pass-through to the batcher hooks) -----------------

    def queue_depth(self) -> int:
        return self.batcher.queue_depth()

    def active_slots(self) -> int:
        return self.batcher.active_slots()

    def free_slots(self) -> int:
        return self.batcher.free_slots()

    # -- admission ---------------------------------------------------------

    def submit(self, frames, on_nonfinite: str = "quarantine"):
        """Bounded-queue admission. Returns ``(uid, admitted)``; a
        rejection is also recorded as a ``ServeResult`` so every uid has
        a terminal outcome."""
        if self.batcher.queue_depth() >= self.policy.max_queue:
            uid = next(self.batcher._uid)
            self.counters["rejected"] += 1
            res = ServeResult(uid, "rejected", error={
                "reason": "queue_full", "depth": self.batcher.queue_depth(),
                "max_queue": self.policy.max_queue})
            self.results.append(res)
            self.n_submitted += 1
            return uid, False
        uid = self.batcher.submit(frames, on_nonfinite=on_nonfinite)
        self._submit_tick[uid] = self.tick_no
        self.n_submitted += 1
        return uid, True

    # -- the supervised tick ----------------------------------------------

    def tick(self) -> list[ServeResult]:
        """One supervised scheduler tick; returns the streams that reached
        a terminal state this tick (ok / shed / quarantined-rejected)."""
        t0 = time.perf_counter()
        p = self.policy
        out: list[ServeResult] = []
        # checkpoint FIRST: the published state then corresponds exactly
        # to "everything up to and including the previous tick", which is
        # also exactly what the caller's result bookkeeping has seen — so
        # a sidecar written here can never disagree with the engine tree
        # published immediately after it
        if (p.ckpt_dir and p.ckpt_every
                and self.tick_no and self.tick_no % p.ckpt_every == 0):
            self.checkpoint()
        gap = self.heartbeat.age("serve")
        if gap > p.heartbeat_deadline_s:
            self.counters["missed_heartbeats"] += 1
        self.heartbeat.beat("serve")

        # 1. shed queued requests that out-waited their tick deadline
        #    (only QUEUED ones — admitted streams own a slot and finish)
        if p.deadline_ticks is not None and self.batcher.queue:
            keep: collections.deque = collections.deque()
            for req in self.batcher.queue:
                waited = self.tick_no - self._submit_tick.get(req.uid,
                                                              self.tick_no)
                if waited >= p.deadline_ticks:
                    self.counters["shed"] += 1
                    res = ServeResult(req.uid, "shed", error={
                        "reason": "deadline", "queued_ticks": waited,
                        "deadline_ticks": p.deadline_ticks})
                    self.results.append(res)
                    out.append(res)
                    self._submit_tick.pop(req.uid, None)
                else:
                    keep.append(req)
            self.batcher.queue = keep

        # 2. one batched engine step (admit / feed / harvest)
        finished = self.batcher.step()
        self.tick_no += 1

        # 3. reconcile fresh admissions: open_stream already seeded their
        #    device-side rollback target at session start, so the host
        #    baselines start at zero
        for sid, req in enumerate(self.batcher.slots):
            if req is None:
                self._slot_uid.pop(sid, None)
            elif self._slot_uid.get(sid) != req.uid:
                self._slot_uid[sid] = req.uid
                self._snap_cursor[sid] = 0
                self._snap_nout[sid] = 0
                self._snap_bad[sid] = 0.0

        # 4. poison bookkeeping for the frames just fed — host numpy, no
        #    sync; the device guard has already masked them
        for sid, req in enumerate(self.batcher.slots):
            if req is None:
                continue
            if not np.isfinite(req.frames[req.cursor - 1]).all():
                self.counters["poison_frames"] += 1
                seen = self._poison_seen.get(req.uid, 0) + 1
                self._poison_seen[req.uid] = seen
                if seen >= p.quarantine_after:
                    res = self._quarantine(sid, req, "poison_frames")
                    if res is not None:
                        out.append(res)
        for req in finished:
            if not np.isfinite(req.frames[req.cursor - 1]).all():
                self.counters["poison_frames"] += 1

        # 5. package completions. A slot whose state went non-finite can
        # finish BETWEEN check ticks (the corruption-screen cadence) —
        # its session stats carry ``bad_state_steps``, already paid for by
        # the harvest sync, so the escape is caught here: the outputs are
        # garbage, quarantine instead of packaging. The slot itself is
        # clean for the next session (open_stream re-zeroes its rows).
        for req in finished:
            if req.stats and req.stats.get("bad_state_steps", 0) > 0:
                self.counters["quarantined"] += 1
                self._poison_seen.pop(req.uid, None)
                if p.on_quarantine == "reject":
                    self._submit_tick.pop(req.uid, None)
                    res = ServeResult(req.uid, "quarantined",
                                      stats=req.stats, error={
                                          "reason": "state_corruption",
                                          "detected_at": "harvest"})
                    self.results.append(res)
                    out.append(res)
                    continue
                # readmit: full replay through a fresh slot — recurrent
                # replay is deterministic, so the retried outputs equal an
                # undisturbed run's
                self.counters["recovered"] += 1
                self._recovered.add(req.uid)
                self.batcher.queue.appendleft(
                    StreamRequest(req.uid, sanitize_frames(req.frames)))
                self._submit_tick[req.uid] = self.tick_no
                continue
            err = None
            if req.uid in self._recovered:
                err = {"recovered_after_quarantine": True}
                self._recovered.discard(req.uid)
            elif req.stats and req.stats.get("poison_steps", 0) > 0:
                err = {"poison_frames_masked": req.stats["poison_steps"]}
            res = ServeResult(req.uid, "ok", outputs=req.outputs,
                              stats=req.stats, error=err)
            self.counters["completed"] += 1
            self.results.append(res)
            out.append(res)
            self._submit_tick.pop(req.uid, None)
            self._poison_seen.pop(req.uid, None)

        # 6. check tick: the ONE amortized host sync
        if self.tick_no % p.check_every == 0:
            out.extend(self._check_tick())

        wall = time.perf_counter() - t0
        self.tick_wall_s.append(wall)
        self._best_wall = wall if self._best_wall is None \
            else min(self._best_wall, wall)
        rep = self.straggler.observe_solo("serve", wall, self._best_wall)
        if "serve" in rep.stragglers:
            self.counters["straggler_flags"] += 1
        return out

    def _check_tick(self) -> list[ServeResult]:
        p = self.policy
        out: list[ServeResult] = []
        host = self.engine.host_carry()
        healthy = []
        for sid, req in enumerate(self.batcher.slots):
            if req is None:
                continue
            if float(host["bad_state"][sid]) > self._snap_bad.get(sid, 0.0):
                res = self._quarantine(sid, req, "state_corruption")
                if res is not None:
                    out.append(res)
            else:
                healthy.append(sid)
        if healthy:
            self.engine.snapshot_streams(healthy)
            for sid in healthy:
                req = self.batcher.slots[sid]
                self._snap_cursor[sid] = req.cursor
                self._snap_nout[sid] = len(req.outputs)
                self._snap_bad[sid] = float(host["bad_state"][sid])
        if p.overload_queue is not None:
            # the overload-Θ watermark reads pressure through the batcher's
            # observability hook, not by poking its private deque
            depth = self.batcher.queue_depth()
            new_theta = float(dynamic_threshold(
                torch.tensor(self._theta_now, dtype=torch.float32),
                float(depth),
                float(p.overload_queue), gain=p.overload_gain,
                theta_min=self._theta_base, theta_max=p.theta_max))
            if new_theta != self._theta_now:
                if new_theta > self._theta_now:
                    self.counters["theta_raises"] += 1
                self._theta_now = new_theta
                self.theta_peak = max(self.theta_peak, new_theta)
                self.engine.set_theta_h(new_theta)
        return out

    def _quarantine(self, sid: int, req, reason: str):
        """Roll the slot back to its last healthy snapshot, then either
        sanitize-and-resume the stream in place (``on_quarantine=
        "readmit"``) or close it out with a structured error
        (``"reject"``). Returns the terminal ServeResult for the reject
        path, None for readmit (the stream keeps running)."""
        self.counters["quarantined"] += 1
        rewound = self.engine.rollback_stream(sid)
        req.outputs = req.outputs[:self._snap_nout.get(sid, 0)]
        req.cursor = self._snap_cursor.get(sid, 0)
        self._poison_seen[req.uid] = 0
        if self.policy.on_quarantine == "reject":
            stats = self.engine.close_stream(sid)   # cold path: may sync
            self.batcher.slots[sid] = None
            self._slot_uid.pop(sid, None)
            self._submit_tick.pop(req.uid, None)
            res = ServeResult(req.uid, "quarantined", stats=stats, error={
                "reason": reason, "rewound_to_session_step": rewound})
            self.results.append(res)
            return res
        # sanitize-and-resume: the remaining frames replay from the
        # snapshot cursor with the poison masked host-side (same silent-
        # regime semantics as the device guard), so one stream's bad feed
        # costs only its own rewound steps
        req.frames = sanitize_frames(req.frames)
        self._recovered.add(req.uid)
        self.counters["recovered"] += 1
        return None

    # -- draining / reporting / checkpoint --------------------------------

    def run_until_drained(self, max_ticks: int = 100000):
        """Supervised drain (strict — raises on tick-budget truncation)."""
        done: list[ServeResult] = []
        for _ in range(max_ticks):
            done += self.tick()
            if (not self.batcher.queue
                    and not any(r is not None for r in self.batcher.slots)):
                return done
        raise RuntimeError(
            f"resilient drain truncated at max_ticks={max_ticks}: "
            f"{len(self.batcher.queue)} queued + "
            f"{sum(r is not None for r in self.batcher.slots)} in-flight")

    def p99_tick_wall_s(self) -> float:
        if not self.tick_wall_s:
            return 0.0
        walls = sorted(self.tick_wall_s)
        return walls[min(len(walls) - 1, int(0.99 * len(walls)))]

    def report(self) -> dict:
        return {
            "ticks": self.tick_no,
            "submitted": self.n_submitted,
            "queue_depth": self.batcher.queue_depth(),
            "counters": dict(self.counters),
            "theta_peak": self.theta_peak,
            "p99_tick_wall_s": self.p99_tick_wall_s(),
            "engine": self.engine.report(),
        }

    def checkpoint(self) -> str:
        """Publish sidecar JSON + engine checkpoint (in that order: the
        engine save's atomic LATEST publish is the commit point, so a
        crash between the two leaves LATEST at the previous step whose
        sidecar already exists)."""
        p = self.policy
        step = self.tick_no
        os.makedirs(p.ckpt_dir, exist_ok=True)
        sidecar = {
            "tick": self.tick_no,
            "n_submitted": self.n_submitted,
            "counters": dict(self.counters),
            "theta_peak": self.theta_peak,
            "theta_now": self._theta_now,
        }
        if self.ckpt_extra is not None:
            sidecar.update(self.ckpt_extra())
        path = os.path.join(p.ckpt_dir, f"serve_{step:08d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sidecar, f, indent=1)
        os.replace(tmp, path)
        return self.engine.checkpoint(p.ckpt_dir, step=step)


def load_sidecar(ckpt_dir: str) -> dict | None:
    """The serve-side metadata matching the LATEST engine checkpoint."""
    step = ft_checkpoint.latest_step(ckpt_dir)
    if step is None:
        return None
    with open(os.path.join(ckpt_dir, f"serve_{step:08d}.json")) as f:
        return json.load(f)


def serve_resumable(program, task, arrivals, policy: ResiliencePolicy, *,
                    n_streams: int = 8, engine_kwargs: dict | None = None,
                    fault_plan=None, on_tick=None, max_ticks: int = 100000,
                    retryable: tuple = (SimulatedCrash,)):
    """Run an arrival schedule through a supervised server, surviving
    crashes via :func:`repro_torch.ft.restart.with_restarts`. The engine
    runs where ``engine_kwargs`` puts it (``device=``, default ``"cuda"``).

    ``arrivals``: ``[(tick, frames), ...]`` sorted by tick — a
    deterministic schedule, which is what makes the whole chaos run
    reproducible. ``fault_plan`` (a :class:`repro_torch.serve.faults.
    FaultPlan`)
    injects poison/corruption/stalls/the crash.

    On restart the body restores the engine from the published
    checkpoint (written into the new engine's buffers after it captured
    its graph), DISCARDS the streams that were in flight (their host-side
    partial outputs died with the process), and replays them from frame 0
    through freshly reset slots — recurrent replay is deterministic, so
    their final outputs are bit-identical to an undisturbed run, while the
    engine's lifetime aggregates continue exactly from the checkpoint.

    Returns ``(results, server, restarts)`` — ``results`` maps arrival
    index -> terminal :class:`ServeResult`.
    """
    results: dict[int, ServeResult] = {}
    engine_kwargs = dict(engine_kwargs or {})
    plan = fault_plan

    def body():
        nonlocal results
        side = load_sidecar(policy.ckpt_dir) if policy.ckpt_dir else None
        if side is not None:
            engine = DeltaStreamEngine.restore(
                policy.ckpt_dir, program, task, n_streams=n_streams,
                **engine_kwargs)
            # in-flight slots lost their host-side request state with the
            # crash: close them out (their executed steps stay in the
            # lifetime aggregates) and replay those arrivals from scratch
            host = engine.host_carry()
            for sid in range(engine.n_streams):
                if engine._slot_busy[sid]:
                    engine.close_stream(sid, host_carry=host)
            srv = ResilientStreamServer(DeltaStreamBatcher(engine), policy)
            srv.tick_no = int(side["tick"])
            srv.n_submitted = int(side["n_submitted"])
            srv.counters.update(side["counters"])
            srv.theta_peak = float(side["theta_peak"])
            srv._theta_now = float(side["theta_now"])
            done = set(side["done_arrivals"])
            results = {i: r for i, r in results.items() if i in done}
            next_arrival = int(side["next_arrival"])
            replay = [i for i in side["open_arrivals"]]
        else:
            engine = DeltaStreamEngine(program, task, n_streams=n_streams,
                                       **engine_kwargs)
            srv = ResilientStreamServer(DeltaStreamBatcher(engine), policy)
            next_arrival = 0
            replay = []

        uid2arr: dict[int, int] = {}

        def submit_arrival(i):
            frames = arrivals[i][1]
            if plan is not None:
                frames = plan.poison_stream(i, frames)
            uid, admitted = srv.submit(frames)
            uid2arr[uid] = i
            if not admitted:
                results[i] = srv.results[-1]

        srv.ckpt_extra = lambda: {
            "next_arrival": next_arrival,
            "done_arrivals": sorted(results.keys()),
            "open_arrivals": sorted(i for i in uid2arr.values()
                                    if i not in results),
        }
        for i in replay:
            submit_arrival(i)

        while True:
            tick = srv.tick_no
            if plan is not None:
                plan.maybe_crash(tick)
                if plan.is_stall(tick):
                    time.sleep(plan.stall_s)
                for sid in plan.corruptions(tick):
                    if srv.batcher.slots[sid] is not None:
                        corrupt_slot_state(engine, sid)
            while (next_arrival < len(arrivals)
                   and arrivals[next_arrival][0] <= tick):
                submit_arrival(next_arrival)
                next_arrival += 1
            for res in srv.tick():
                i = uid2arr.get(res.uid)
                if i is not None:
                    results[i] = res
            if on_tick is not None:
                on_tick(srv, tick)
            if (next_arrival >= len(arrivals) and not srv.batcher.queue
                    and not any(r is not None
                                for r in srv.batcher.slots)):
                return srv
            if srv.tick_no >= max_ticks:
                raise RuntimeError(
                    f"serve_resumable exceeded max_ticks={max_ticks} with "
                    f"{len(arrivals) - next_arrival} arrivals pending")

    srv, restarts = with_restarts(body, policy.max_restarts,
                                  retryable=retryable)
    return results, srv, restarts
