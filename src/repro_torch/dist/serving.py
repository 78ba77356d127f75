"""Sharded stream fleet: many engine tiles behind one fabric tick, the
PyTorch port of :mod:`repro.dist.serving`.

A :class:`ShardedStreamFleet` partitions ``n_streams`` stream slots across
the ``"data"`` axis of a ``("data", "model")`` :class:`~repro_torch.dist.
elastic.Mesh` (from :func:`~repro_torch.dist.elastic.best_mesh`). Each
shard is a :class:`~repro_torch.serve.engine.DeltaStreamEngine` of the
per-shard tile width ``B = n_streams / n_shards`` on the shard's device
(the first device of its mesh row; the model axis is replicated, as the
JAX fleet's step is). The shards of one device share one program, the
counterpart of JAX's replicated weights: the fleet builds one program per
physical device, never one per shard.

A fabric tick (:meth:`step`) stages the ``[N, I]`` frame into each shard's
input buffer and replays each shard engine's captured CUDA graph, one
replay a shard where the JAX fleet makes one ``shard_map`` dispatch
(:attr:`graph_stats` counts them); on the CPU each shard steps eagerly.
Because every shard runs the same computation at the same tile width as a
standalone ``n_streams=B`` engine, it IS one, and every shard's outputs are
bitwise those of a single engine fed that shard's rows. The per-shard
accounting is exact by construction: each shard's lifetime aggregates are
its own engine's (the JAX fleet's ``[S]`` aggregate vectors), read by
:meth:`host_carry` in the JAX fleet's carry layout.

Elastic scale-down (:meth:`remove_shard`) consumes :func:`~repro_torch.
dist.elastic.scale_event` for the plan, drain-checkpoints the dying shard
through ``engine.checkpoint`` (the shard exported into a new engine first),
drops its engine and rebuilds the mesh from the surviving devices. The
survivors keep their engines, buffers and graphs untouched, so they
continue bitwise with no recapture.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.program import DeltaProgram
from repro_torch.dist.elastic import Mesh, best_mesh, scale_event
from repro_torch.kernels.ops import resolve_device
from repro_torch.serve.engine import DeltaStreamEngine, StreamStats

__all__ = ["ShardedStreamFleet"]


def _nearest_valid_widths(n_streams: int, s: int) -> tuple[int, int]:
    lo = (n_streams // s) * s
    return max(lo, s), lo + s


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; a CPU tensor goes to a card through pinned
    memory without blocking the host."""
    if x.device == device:
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device, non_blocking=True)


class ShardedStreamFleet:
    """``n_streams`` stream slots sharded over the mesh's data axis.

    Args:
      program: a compiled :class:`~repro_torch.core.program.DeltaProgram`
        with a classifier head (``fused`` / ``fused_q8`` of either cell;
        with a per-shard width > 1 each shard engine routes onto the
        ``*_batch`` tile sibling, so one weight pass per tick serves each
        shard's whole tile), on any device: it is copied once to each
        device of the mesh that does not hold it.
      task: the :class:`~repro_torch.models.gru_rnn.GruTaskConfig`.
      n_streams: fleet-wide slot count; must divide evenly over the data
        axis (each shard runs a fixed-width tile — the bitwise parity and
        rebalance story both require equal widths).
      mesh: a ``("data", "model")`` mesh; defaults to
        ``best_mesh(model_parallel=1)`` over every visible CUDA device.
      thresholds / accel: forwarded to the shard engines.

    Slot ids are global: slot ``sid`` lives on shard ``sid // B`` where
    ``B = streams_per_shard``. Sessions mirror the engine API
    (:meth:`open_stream` takes the target shard, :meth:`close_stream`
    returns the same accounting dict plus the shard id).
    """

    def __init__(self, program, task, *, n_streams: int, mesh=None,
                 thresholds=None, accel=None):
        self.mesh = mesh if mesh is not None else best_mesh(model_parallel=1)
        if "data" not in self.mesh.axis_names:
            raise ValueError(
                f"fleet mesh needs a 'data' axis, got {self.mesh.axis_names}")
        s = int(self.mesh.shape["data"])
        if n_streams < s or n_streams % s:
            lo, hi = _nearest_valid_widths(n_streams, s)
            raise ValueError(
                f"n_streams={n_streams} does not divide over the data axis "
                f"(size {s}): every shard runs a fixed-width tile. Nearest "
                f"valid widths: {lo} ({lo // s}/shard) or {hi} "
                f"({hi // s}/shard)")
        self.n_shards = s
        self.n_streams = n_streams
        self.streams_per_shard = n_streams // s
        kw = {}
        if thresholds is not None:
            kw["thresholds"] = thresholds
        if accel is not None:
            kw["accel"] = accel
        self._engine_kwargs = kw
        self.task = task
        self._source = program
        self._programs: dict = {}          # device -> the program there
        self.engines = [self._engine(self._mesh_device(i)) for i in range(s)]
        first = self.engines[0]
        if first.dynamic_target is not None:  # pragma: no cover
            raise ValueError("dynamic-theta is per-engine state; the fleet "
                             "does not steer per-shard controllers")
        self.program = first.program
        self.backend = first.backend
        self.cell = first.cell
        self.dims = first.dims
        self._out_device = first.device
        self._retired_graph = {"captures": 0, "replays": 0}
        self._n_ticks = 0

    # -- devices and engines ----------------------------------------------

    def _mesh_device(self, shard: int) -> torch.device:
        axis = self.mesh.axis_names.index("data")
        return resolve_device(
            np.take(self.mesh.devices, shard, axis=axis).flat[0])

    def _program_on(self, device: torch.device) -> DeltaProgram:
        if device not in self._programs:
            self._programs[device] = self._source.to(device)
        return self._programs[device]

    def _engine(self, device: torch.device) -> DeltaStreamEngine:
        """A fresh engine at the per-shard tile width on ``device`` (on a
        card it captures its step at construction)."""
        return DeltaStreamEngine(self._program_on(device), self.task,
                                 n_streams=self.streams_per_shard,
                                 device=device, **self._engine_kwargs)

    @property
    def graph_stats(self) -> dict:
        """Captures and replays of every shard engine the fleet ran
        (removed shards' included) and the fleet's ticks: on a card a tick
        is one replay a live shard; on the CPU both counts stay 0."""
        stats = dict(self._retired_graph)
        for eng in self.engines:
            for k in stats:
                stats[k] += eng.graph_stats[k]
        stats["ticks"] = self._n_ticks
        return stats

    def reset(self):
        for eng in self.engines:
            eng.reset()
        self._n_ticks = 0

    # -- hot path ---------------------------------------------------------

    def _frames_by_device(self, x) -> dict:
        """``x`` as a float32 tensor on every device of the fleet: host
        numpy frames are snapshotted with a synchronous copy (the caller
        may reuse its buffer at once), then sent once a device."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x, np.float32))
        x = torch.as_tensor(x, dtype=torch.float32)
        return {dev: _on(x, dev) for dev in {e.device for e in self.engines}}

    def step(self, x) -> torch.Tensor:
        """One fabric tick: ``x [n_streams, I]`` -> ``[n_streams, O]``, a
        tensor of its own (later ticks do not overwrite it) on the first
        shard's device. One replay a shard; no host sync."""
        shape = tuple(np.shape(x))
        if shape != (self.n_streams, self.dims.input_size):
            raise ValueError(
                f"fleet has n_streams={self.n_streams}; step needs "
                f"[{self.n_streams}, {self.dims.input_size}], got {shape}")
        xs = self._frames_by_device(x)
        b = self.streams_per_shard
        out = torch.cat([
            _on(eng.step(xs[eng.device][s * b:(s + 1) * b]).reshape(b, -1),
                self._out_device)
            for s, eng in enumerate(self.engines)])
        self._n_ticks += 1
        return out

    def step_many(self, xs) -> torch.Tensor:
        """``xs [T, n_streams, I]`` -> ``[T, n_streams, O]``: each shard's
        engine runs the chunk (a replay a frame on a card)."""
        shape = tuple(np.shape(xs))
        if len(shape) != 3 or shape[1:] != (self.n_streams,
                                            self.dims.input_size):
            raise ValueError(
                f"fleet step_many needs [T, {self.n_streams}, "
                f"{self.dims.input_size}], got {shape}")
        xs_dev = self._frames_by_device(xs)
        b = self.streams_per_shard
        outs = torch.cat([
            _on(eng.step_many(xs_dev[eng.device][:, s * b:(s + 1) * b]),
                self._out_device)
            for s, eng in enumerate(self.engines)], dim=1)
        self._n_ticks += shape[0]
        return outs

    # -- sessions ---------------------------------------------------------

    def shard_of(self, sid: int) -> int:
        return sid // self.streams_per_shard

    def shard_slots(self, shard: int) -> range:
        b = self.streams_per_shard
        return range(shard * b, (shard + 1) * b)

    def _shards(self, shard: int | None) -> range:
        return range(self.n_shards) if shard is None else range(shard,
                                                                shard + 1)

    def free_streams(self, shard: int | None = None) -> list:
        """Free slot ids (optionally restricted to one shard)."""
        b = self.streams_per_shard
        return [s * b + i for s in self._shards(shard)
                for i in self.engines[s].free_streams]

    def active_slots(self, shard: int | None = None) -> int:
        b = self.streams_per_shard
        return sum(b - len(self.engines[s].free_streams)
                   for s in self._shards(shard))

    def open_stream(self, shard: int) -> int:
        """Claim the first free slot ON the given shard (placement is the
        router's job — the fleet never load-balances by itself). Device
        work only: no host sync."""
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range "
                             f"(n_shards={self.n_shards})")
        eng = self.engines[shard]
        if not eng.free_streams:
            raise RuntimeError(
                f"shard {shard}: all {self.streams_per_shard} slots busy; "
                "queue the request (see serve.router.StreamRouter)")
        return shard * self.streams_per_shard + eng.open_stream()

    def close_stream(self, sid: int, host_carry=None) -> dict:
        """Release a session slot; returns that stream's accounting (the
        engine dict plus ``"shard"``). ``host_carry`` shares one
        :meth:`host_carry` across a tick's harvests."""
        b = self.streams_per_shard
        shard, local = divmod(sid, b)
        if not (0 <= sid < self.n_streams) \
                or local in self.engines[shard].free_streams:
            raise ValueError(f"stream {sid} is not open")
        host = host_carry if host_carry is not None else self.host_carry()
        rows = slice(shard * b, (shard + 1) * b)
        acc = self.engines[shard].close_stream(
            local, host_carry={k: host[k][rows]
                               for k in DeltaStreamEngine._PER_STREAM_KEYS})
        acc.pop("stream")
        return {"stream": sid, "shard": shard, **acc}

    # -- accounting -------------------------------------------------------

    def host_carry(self) -> dict:
        """The fleet's accounting carry on the host, in the layout of the
        JAX fleet's ``jax.device_get(fleet._carry)``: the per-stream keys
        ``[N]``, ``last_x`` ``[N, I]``, every ``agg_*`` key and ``theta_h``
        ``[S]`` (one element a shard). One device-to-host copy a device."""
        keys = list(self.engines[0]._carry)
        parts = [None] * self.n_shards
        by_device: dict = {}
        for s, eng in enumerate(self.engines):
            by_device.setdefault(eng.device, []).append(s)
        for shards in by_device.values():
            flat = torch.cat([self.engines[s]._carry[k].reshape(-1)
                              for s in shards for k in keys]).cpu().numpy()
            off = 0
            for s in shards:
                parts[s] = {}
                for k in keys:
                    t = self.engines[s]._carry[k]
                    parts[s][k] = flat[off:off + t.numel()].reshape(t.shape)
                    off += t.numel()
        host = {}
        for k in keys:
            if k in DeltaStreamEngine._PER_STREAM_KEYS or k == "last_x":
                host[k] = np.concatenate([p[k] for p in parts])
            else:
                host[k] = np.array([p[k] for p in parts], np.float32)
        return host

    def shard_stats(self, shard: int, host_carry=None) -> StreamStats:
        """One shard's engine-lifetime aggregates (its element of the [S]
        carry vectors) as the engine's own StreamStats type."""
        host = host_carry if host_carry is not None else self.host_carry()
        s = shard
        return StreamStats(
            steps=self._n_ticks,
            fired_x=float(host["agg_fired_x"][s]),
            fired_h=float(host["agg_fired_h"][s]),
            est_latency_s=float(host["agg_lat_s"][s]),
            w_bytes=float(host["agg_w_bytes"][s]),
            ufired_x=float(host["agg_ufired_x"][s]),
            ufired_h=float(host["agg_ufired_h"][s]),
            tile_est_latency_s=float(host["agg_tile_lat_s"][s]),
            tile_w_bytes=float(host["agg_tile_w_bytes"][s]),
            poison_steps=float(host["agg_poison_steps"][s]),
            bad_state_steps=float(host["agg_bad_state"][s]),
        )

    def report(self) -> dict:
        """Fleet + per-shard accounting in one carry read.

        Rate aggregates (firing means, Eq. 7 terms) average over shards
        (equal tile widths, so the mean is exact); event counts (poison /
        bad-state totals) SUM over shards — they are exact counters."""
        host = self.host_carry()
        per_shard = [self.shard_stats(s, host_carry=host)
                     for s in range(self.n_shards)]
        ticks = max(self._n_ticks, 1)
        return {
            "n_shards": self.n_shards,
            "streams_per_shard": self.streams_per_shard,
            "n_streams": self.n_streams,
            "ticks": self._n_ticks,
            "mesh": dict(self.mesh.shape),
            "backend": self.backend,
            "cell": self.cell,
            "active_slots": self.active_slots(),
            "gamma_dx": float(
                1.0 - np.mean([st.fired_x for st in per_shard]) / ticks),
            "gamma_dh": float(
                1.0 - np.mean([st.fired_h for st in per_shard]) / ticks),
            "mean_est_latency_us": float(
                1e6 * np.mean([st.est_latency_s for st in per_shard])
                / ticks),
            "mean_weight_bytes_per_step": float(
                np.mean([st.w_bytes for st in per_shard]) / ticks),
            "poison_steps": float(
                np.sum([st.poison_steps for st in per_shard])),
            "bad_state_steps": float(
                np.sum([st.bad_state_steps for st in per_shard])),
            "per_shard": [{
                "shard": s,
                "gamma_dx": st.gamma_dx,
                "gamma_dh": st.gamma_dh,
                "union_gamma_dx": st.union_gamma_dx,
                "union_gamma_dh": st.union_gamma_dh,
                "tile_weight_bytes_per_step": st.tile_w_bytes / ticks,
                "poison_steps": st.poison_steps,
                "bad_state_steps": st.bad_state_steps,
            } for s, st in enumerate(per_shard)],
        }

    # -- elastic scale-down ----------------------------------------------

    def reference_engine(self, device=None) -> DeltaStreamEngine:
        """A fresh standalone engine at the per-shard tile width — the
        clean same-width reference every fleet stream must match bitwise —
        on ``device`` (default: the first shard's)."""
        dev = self._out_device if device is None else resolve_device(device)
        return self._engine(dev)

    def export_shard_engine(self, shard: int) -> DeltaStreamEngine:
        """Materialize ONE shard as a new standalone template-width engine
        on its device (never the live shard engine).

        The shard's state, accounting carry and slot bookkeeping are written
        into the new engine's buffers, its rollback shadows seeded at that
        state — so ``engine.checkpoint`` on the export IS the
        drain-checkpoint of the dying shard, restorable by either package's
        ``DeltaStreamEngine.restore``.
        """
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range")
        src = self.engines[shard]
        eng = self.reference_engine(src.device)
        eng._write(eng.state, eng._carry, src.state, src._carry)
        # seed the rollback shadows at the exported state (a restore-side
        # rollback rewinds at worst to the drain point, never further)
        eng._write(eng._snap_state, eng._snap_carry, src.state, src._carry)
        eng._n_steps = self._n_ticks
        eng._slot_busy = list(src._slot_busy)
        eng._slot_opened_at = list(src._slot_opened_at)
        eng._snap_steps = [self._n_ticks - o for o in eng._slot_opened_at]
        return eng

    def checkpoint_shard(self, shard: int, ckpt_dir: str,
                         step: int | None = None) -> str:
        """Drain-checkpoint one shard via ``engine.checkpoint``."""
        return self.export_shard_engine(shard).checkpoint(ckpt_dir, step=step)

    def remove_shard(self, dead: int, ckpt_dir: str | None = None) -> dict:
        """Simulated device loss: drop shard ``dead``, keep survivors
        bitwise.

        Consumes :func:`~repro_torch.dist.elastic.scale_event` for the
        remesh plan, drain-checkpoints the dying shard first when
        ``ckpt_dir`` is given, drops its engine and rebuilds the mesh from
        the SURVIVING device rows (the plan's new shape alone would
        re-admit the dead device). The surviving engines are not touched,
        so their streams continue with exactly the bits they had.

        Returns the plan plus ``sid_map`` (old surviving slot id -> new),
        the checkpoint path (if drained), and the displaced slot ids whose
        streams must be replayed from frame 0 by the caller (the router).
        """
        if not (0 <= dead < self.n_shards):
            raise ValueError(f"shard {dead} out of range "
                             f"(n_shards={self.n_shards})")
        mp = int(self.mesh.shape.get("model", 1))
        # raises ValueError before any mutation when scaling to zero
        plan = scale_event(self.mesh, (self.n_shards - 1) * mp,
                           model_parallel=mp)
        ckpt_path = None
        if ckpt_dir is not None:
            ckpt_path = self.checkpoint_shard(dead, ckpt_dir)
        b = self.streams_per_shard
        busy = set(range(b)) - set(self.engines[dead].free_streams)
        displaced = [dead * b + i for i in sorted(busy)]

        surviving = np.delete(self.mesh.devices, dead,
                              axis=self.mesh.axis_names.index("data"))
        self.mesh = Mesh(surviving, self.mesh.axis_names)
        assert dict(self.mesh.shape) == plan["new_shape"], \
            (dict(self.mesh.shape), plan["new_shape"])
        gone = self.engines.pop(dead)
        for k in self._retired_graph:
            self._retired_graph[k] += gone.graph_stats[k]
        keep = [i for i in range(self.n_streams)
                if not dead * b <= i < (dead + 1) * b]
        self.n_shards -= 1
        self.n_streams -= b
        sid_map = {old: new for new, old in enumerate(keep)}
        return {
            "plan": plan,
            "dead_shard": dead,
            "checkpoint": ckpt_path,
            "displaced": displaced,
            "sid_map": sid_map,
        }
