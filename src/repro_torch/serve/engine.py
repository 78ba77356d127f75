"""Serving engines, the PyTorch port of :mod:`repro.serve.engine`.

``LmEngine`` — batched prefill and decode for a registry arch over a fixed
slot count, with ring caches of per-slot lengths for continuous batching;
it runs eagerly (the JAX engine jits each step).

``DeltaStreamEngine`` — streaming delta-RNN inference with live
temporal-sparsity accounting and the Eq. 7 latency model.
``GruStreamEngine`` is an alias of the class.

Hand it a compiled program (:func:`repro_torch.core.program.
compile_delta_program` or :func:`repro_torch.quant.export.
quantize_delta_model`): ``DeltaStreamEngine(program, task)``. With
``n_streams > 1`` a ``fused`` / ``fused_q8`` / ``fused_q4`` program is
routed onto its ``*_batch`` sibling (same packed weights, bit-identical
outputs), so one weight pass per layer step serves the whole stream tile,
and :meth:`report` adds the tile terms priced on the union firing. The LM
cells (``rwkv6``, ``rglru``) have no ``*_batch`` sibling and keep
``fused``, whose ``delta_spmv`` kernel already compacts on the union of
fired blocks across the tile, as in the JAX engine.

The hot loop does not synchronise the host: the firing statistics, the
Eq. 7 terms, the dynamic-Θ controller and the resilience counters are
tensors on the device, updated by every step; nothing is copied to the
host until :attr:`stats`, :meth:`report` or :meth:`close_stream` reads
them. A host numpy frame is snapshotted (a synchronous numpy copy) and sent
to a CUDA device through pinned memory without blocking.

The step is the port's ``jax.jit(_step)``. The engine keeps its state, its
carry and its input frame in fixed buffers, and every step and session
call writes into them in place. On a CUDA device one step over those
buffers is captured once as a CUDA graph (at construction, and again when
a value it bakes in changes: :meth:`_capture_key`), and ``step`` /
``step_many`` replay it, one graph launch a step; a capture or replay that
fails raises. On the CPU, where no graph exists, the same step runs
eagerly. ``graph_stats`` counts the captures and replays.

``mean_est_latency_us`` and the other Eq. 7 figures are the modelled
latencies of the paper's FPGA (:class:`~repro_torch.core.perf_model.
AcceleratorSpec`, 125 MHz), not times measured on the GPU.

Resilience (device-side, no sync): a frame guard replaces a frame with any
non-finite component by that stream's previous frame (the zero-delta
silent regime) and counts it in ``poison_steps``; ``bad_state`` counts
steps whose post-step state went non-finite; :meth:`snapshot_streams` /
:meth:`rollback_stream` keep and restore per-slot shadow rows.
:meth:`checkpoint` / :meth:`restore` save and load the state, carry,
shadows and slot bookkeeping in :mod:`repro_torch.ft.checkpoint`'s format
(the JAX engine's manifest, path for path). Every one of these writes into
the buffers, never rebinds them: a CUDA graph replays over the buffers it
captured, and would not see a tensor put in their place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.perf_model import (EDGEDRNN, AcceleratorSpec,
                                         dram_traffic_bytes_per_timestep,
                                         estimate_stack, spec_for_backend,
                                         stack_effective_macs)
from repro_torch.core.program import (DeltaProgram, DeltaProgramState,
                                      compile_delta_program, infer_cell)
from repro_torch.core.sparsity import cell_dims, recip_mean
from repro_torch.core.thresholds import ThresholdPolicy, dynamic_threshold
from repro_torch.configs.base import ModelConfig
from repro_torch.ft import checkpoint as ft_checkpoint
from repro_torch.kernels import ops
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.models.gru_rnn import GruTaskConfig
from repro_torch.models.lm import init_lm_caches, lm_decode, lm_prefill


def _map2(fn, a, b):
    """Apply ``fn`` to matching tensor leaves of two program states."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, DeltaProgramState):
        return replace(a, stack=_map2(fn, a.stack, b.stack))
    if isinstance(a, tuple):
        vals = [_map2(fn, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    raise TypeError(f"unexpected state node {type(a).__name__}")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        raise TypeError(f"unexpected state node {type(tree).__name__}")


def _clone(state):
    """A program state whose every leaf is a tensor of its own."""
    return _map2(lambda a, _: a.clone(), state, state)


def _copy_into(dsts: list, srcs: list) -> None:
    """Write ``srcs`` into the buffers ``dsts`` in place, one
    ``_foreach_copy_``. A source that is its own buffer (a value passed
    through unchanged) is skipped; one that shares memory with another
    buffer is copied out first, so no buffer is overwritten before it is
    read."""
    own = {d.untyped_storage().data_ptr(): i for i, d in enumerate(dsts)}
    pairs = []
    for i, (d, s) in enumerate(zip(dsts, srcs, strict=True)):
        j = own.get(s.untyped_storage().data_ptr())
        if j == i and s.data_ptr() == d.data_ptr():
            continue
        pairs.append((d, s if j is None else s.clone()))
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _capture_cuda_graph(body):
    """Capture ``body`` (one engine step over its fixed buffers, returning
    its output) into a CUDA graph on a side stream, without synchronising
    the host (``torch.cuda.graph`` would). Returns ``replay() -> output``:
    one graph launch, then the graph's own output buffer."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            out = body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)

    def replay():
        graph.replay()
        return out

    return replay


class LmEngine:
    """Prefill / decode engine over a fixed slot count (the decode batch).

    ``params`` (from :func:`repro_torch.models.lm.init_lm` or
    :func:`~repro_torch.models.lm.lm_params_from_numpy`) must lie on
    ``device`` (default ``"cuda"``), where the engine keeps its caches.
    Prefill and decode write the caches in place; ``caches`` may be
    replaced between calls (the batcher's slotwise merge does)."""

    def __init__(self, params: dict, cfg: ModelConfig, batch: int,
                 max_len: int, device=None):
        self.device = resolve_device(device)
        where = {t.device for t in tree_leaves(params)}
        if where != {self.device}:
            raise ValueError(f"LmEngine on {self.device}: the parameters lie "
                             f"on {sorted(map(str, where))}")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.caches = init_lm_caches(cfg, batch, max_len, self.device)

    @torch.no_grad()
    def prefill(self, tokens, **modality) -> torch.Tensor:
        """Prefill all slots with (left-padded) prompts ``[B, S]``; returns
        the last logits ``[B, 1, V]``. The VLM takes ``image_embeds=``, the
        encoder-decoder ``audio_frames=`` (arrays in the model's dtype)."""
        logits, self.caches = lm_prefill(
            self.params, self.cfg, torch.as_tensor(tokens, device=self.device),
            self.caches, **{k: torch.as_tensor(v, device=self.device)
                            for k, v in modality.items()})
        return logits

    @torch.no_grad()
    def decode_step(self, tokens) -> torch.Tensor:
        """One decode step for every slot, ``tokens: [B, 1]``."""
        logits, self.caches = lm_decode(
            self.params, self.cfg, torch.as_tensor(tokens, device=self.device),
            self.caches)
        return logits

    def generate_greedy(self, tokens, steps: int, **modality) -> torch.Tensor:
        """Greedy generation; returns ``[B, steps]`` new tokens."""
        logits = self.prefill(tokens, **modality)
        out = []
        cur = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(steps):
            out.append(cur)
            logits = self.decode_step(cur)
            cur = torch.argmax(logits[:, -1:], dim=-1)
        return torch.cat(out, dim=1)


@dataclass
class StreamStats:
    """Aggregate (stream-averaged) accounting, one device sync per read.
    The ``ufired_*`` / ``tile_*`` fields are the batched-tile terms."""

    steps: int = 0
    fired_x: float = 0.0
    fired_h: float = 0.0
    est_latency_s: float = 0.0
    w_bytes: float = 0.0
    ufired_x: float = 0.0
    ufired_h: float = 0.0
    tile_est_latency_s: float = 0.0
    tile_w_bytes: float = 0.0
    poison_steps: float = 0.0
    bad_state_steps: float = 0.0

    @property
    def gamma_dx(self) -> float:
        return 1.0 - self.fired_x / max(self.steps, 1)

    @property
    def gamma_dh(self) -> float:
        return 1.0 - self.fired_h / max(self.steps, 1)

    @property
    def union_gamma_dx(self) -> float:
        return 1.0 - self.ufired_x / max(self.steps, 1)

    @property
    def union_gamma_dh(self) -> float:
        return 1.0 - self.ufired_h / max(self.steps, 1)


class DeltaStreamEngine:
    """Streaming delta-RNN inference (the EdgeDRNN deployment mode).

    Args:
      program: a compiled :class:`~repro_torch.core.program.DeltaProgram`
        with a head (compiled from a model params dict). A raw params dict
        is also accepted and compiled here with ``backend=`` / ``layouts=``.
      task: network config (sizes + default thresholds).
      thresholds: static dual-threshold policy, optionally per-layer
        (mutually exclusive with the dynamic controller).
      accel: accelerator spec of the Eq. 7 model.
      dynamic_target_fired: if set, the closed-loop Θ_h controller tracks
        this firing fraction, on the device.
      n_streams: stream slots batched through one kernel launch per layer
        step; ``step`` / ``step_many`` then take ``[N, I]`` / ``[T, N, I]``.
      device: where the engine runs; default ``"cuda"`` (raises without a
        card unless ``device="cpu"``). A compiled program must already be
        on that device.
    """

    _PER_STREAM_KEYS = ("fired_x", "fired_h", "lat_s", "w_bytes",
                        "poison_steps", "bad_state")

    def __init__(self, program, task: GruTaskConfig,
                 thresholds: ThresholdPolicy | None = None,
                 accel: AcceleratorSpec = EDGEDRNN,
                 dynamic_target_fired: float | None = None,
                 backend: str | None = None,
                 layouts=None,
                 n_streams: int = 1,
                 device=None):
        self.device = resolve_device(device)
        if isinstance(program, DeltaProgram):
            if backend is not None and backend != program.backend:
                raise ValueError(
                    f"backend={backend!r} conflicts with the compiled "
                    f"program's backend {program.backend!r}; drop the kwarg")
            if layouts is not None:
                raise ValueError("layouts= is meaningless with a compiled "
                                 "program — it already holds its layouts")
            if program.device != self.device:
                raise ValueError(
                    f"the program lives on {program.device} but the engine "
                    f"runs on {self.device}; compile with device="
                    f"{str(self.device)!r} or pass device={str(program.device)!r}")
        else:
            program = compile_delta_program(program,
                                            backend=backend or "fused",
                                            cell=infer_cell(program),
                                            layouts=layouts,
                                            device=self.device)
        if program.head is None:
            raise ValueError(
                "DeltaStreamEngine needs a program with a classifier head; "
                "compile from a model params dict (init_gru_model, "
                "init_lstm_model, init_deltarwkv_model or "
                "init_deltarglru_model)")
        # A tile of streams pays ONE weight fetch per step: swap onto the
        # pack-compatible "*_batch" sibling when one is registered.
        if n_streams > 1 and program.spec.weight_fetch != "tile":
            try:
                program = program.with_backend(program.backend + "_batch")
            except ValueError:
                pass
        self._tile_fetch = program.spec.weight_fetch == "tile"
        self.program = program
        self.head = (program.head, program.head_b)
        self.task = task
        self.cell = program.cell
        self.accel = spec_for_backend(accel, program.backend,
                                      cell=program.cell)
        self.backend = program.backend
        self.n_streams = n_streams
        self.thresholds = thresholds or ThresholdPolicy(task.theta_x,
                                                        task.theta_h)
        self.theta_x = self.thresholds.theta_x
        self.dynamic_target = dynamic_target_fired
        self.dims = cell_dims(program.cell, task.input_size,
                              task.hidden_size, task.num_layers)
        self._per_layer = self.thresholds.has_per_layer
        if self._per_layer:
            if dynamic_target_fired is not None:
                raise ValueError(
                    "per-layer thresholds and the dynamic-theta controller "
                    "are mutually exclusive: the controller adjusts one "
                    "scalar theta_h, which would silently override the "
                    "per-layer policy")
            self._theta_x_layers, self._theta_h_layers = \
                self.thresholds.layer_thetas(task.num_layers)
        else:
            self._theta_x_layers = self._theta_h_layers = None
        # the fixed buffers: the frame here, the state and carry (and their
        # rollback shadows) from reset
        self._x = torch.zeros((n_streams, task.input_size),
                              dtype=torch.float32, device=self.device)
        self.state = None
        self.reset()
        # the captured step: on a CUDA device only (the CPU steps eagerly)
        self._capture = (_capture_cuda_graph if self.device.type == "cuda"
                         else None)
        self._replay = None
        self._graph_key = self._graph_program = None
        self._graph_launches = ()
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
        if self._capture is not None:
            self._capture_step()

    # -- the step (tensor ops only: no host sync) --------------------------

    def _nonfinite_rows(self, state: DeltaProgramState) -> torch.Tensor:
        """Per-stream flag ``[N]``: any non-finite value in the state."""
        n = self.n_streams
        flags = torch.zeros((n,), dtype=torch.float32, device=self.device)
        for leaf in _leaves(state.stack):
            bad = torch.any(~torch.isfinite(leaf.reshape(n, -1)), dim=-1)
            flags = torch.maximum(flags, bad.to(torch.float32))
        return flags

    def _latency_s(self, gamma_dx, gamma_dh) -> torch.Tensor:
        """Eq. 7 latency of one step (:func:`stack_latency_s`), dividing by
        the MAC rate through its reciprocal like :func:`recip_mean`."""
        rate = self.accel.k_pes * self.accel.f_pl_hz
        return stack_effective_macs(self.dims, gamma_dx, gamma_dh) * (
            1.0 / rate)

    def _one_step(self, state, carry: dict, x: torch.Tensor):
        """One timestep with the frame guard, firing statistics, Eq. 7
        terms and the Θ controller, all on the device."""
        finite = torch.all(torch.isfinite(x), dim=-1)            # [N]
        x = torch.where(finite[:, None], x, carry["last_x"])
        poison = 1.0 - finite.to(torch.float32)                   # [N]
        tx = self._theta_x_layers if self._per_layer else self.theta_x
        th = self._theta_h_layers if self._per_layer else carry["theta_h"]
        y, new_state, deltas = self.program.step(state, x, tx, th)
        bad = self._nonfinite_rows(new_state)                     # [N]
        out = y @ self.head[0] + self.head[1]
        f32 = torch.float32
        fx = recip_mean(torch.stack(
            [recip_mean((dx != 0).to(f32), dim=-1) for dx, _ in deltas]),
            dim=0)                                                # [N]
        fh = recip_mean(torch.stack(
            [recip_mean((dh != 0).to(f32), dim=-1) for _, dh in deltas]),
            dim=0)                                                # [N]
        theta_h = carry["theta_h"]
        if self.dynamic_target is not None:
            theta_h = dynamic_threshold(theta_h, recip_mean(fh),
                                        self.dynamic_target)
        lat = self._latency_s(1.0 - fx, 1.0 - fh)
        wb = dram_traffic_bytes_per_timestep(
            self.dims, 1.0 - fx, 1.0 - fh,
            w_weight_bits=self.accel.w_weight_bits)
        # tile economics: a column is fetched when ANY stream fired it
        ufx = recip_mean(torch.stack(
            [recip_mean(torch.any(dx != 0, dim=0).to(f32))
             for dx, _ in deltas]))
        ufh = recip_mean(torch.stack(
            [recip_mean(torch.any(dh != 0, dim=0).to(f32))
             for _, dh in deltas]))
        tile_lat = self._latency_s(1.0 - ufx, 1.0 - ufh)
        tile_wb = dram_traffic_bytes_per_timestep(
            self.dims, 1.0 - ufx, 1.0 - ufh,
            w_weight_bits=self.accel.w_weight_bits)
        new_carry = {
            # per-stream accumulators ([N]): session accounting
            "fired_x": carry["fired_x"] + fx,
            "fired_h": carry["fired_h"] + fh,
            "lat_s": carry["lat_s"] + lat,
            "w_bytes": carry["w_bytes"] + wb,
            # engine-lifetime aggregates (scalars), never reset by sessions
            "agg_fired_x": carry["agg_fired_x"] + recip_mean(fx),
            "agg_fired_h": carry["agg_fired_h"] + recip_mean(fh),
            "agg_lat_s": carry["agg_lat_s"] + recip_mean(lat),
            "agg_w_bytes": carry["agg_w_bytes"] + recip_mean(wb),
            "agg_ufired_x": carry["agg_ufired_x"] + ufx,
            "agg_ufired_h": carry["agg_ufired_h"] + ufh,
            "agg_tile_lat_s": carry["agg_tile_lat_s"] + tile_lat,
            "agg_tile_w_bytes": carry["agg_tile_w_bytes"] + tile_wb,
            # resilience carry
            "last_x": x,
            "poison_steps": carry["poison_steps"] + poison,
            "bad_state": carry["bad_state"] + bad,
            "agg_poison_steps": carry["agg_poison_steps"] + torch.sum(poison),
            "agg_bad_state": carry["agg_bad_state"] + torch.sum(bad),
            "theta_h": theta_h,
        }
        return out, new_state, new_carry

    def _write(self, dst_state, dst_carry, src_state, src_carry):
        """Write a state and carry into buffers (the live ones or the
        rollback shadow), in place."""
        _copy_into(list(_leaves(dst_state.stack)) + list(dst_carry.values()),
                   list(_leaves(src_state.stack))
                   + [src_carry[k] for k in dst_carry])

    def _capture_key(self) -> tuple:
        """What a captured step bakes in as Python values: the program (its
        weights, head, backend and stream tile), ``theta_x``, the per-layer
        thresholds and the dynamic controller's target. ``theta_h`` is a
        buffer of the carry and stays live."""
        return (id(self.program), self.backend, self.n_streams, self.theta_x,
                self._theta_x_layers, self._theta_h_layers,
                self.dynamic_target)

    def _capture_step(self):
        """Capture one step over the buffers with ``self._capture``. The
        step first runs once on scratch copies of the state and carry, so
        what runs on first use (kernel builds, launch plans, cuBLAS's handle
        and workspace) runs outside the capture and no stream advances;
        those launches ran and stay counted. The capture calls every kernel
        wrapper once and runs no kernel: its counts are taken back and added
        again at each replay."""
        t0 = time.perf_counter()
        scratch = (_clone(self.state),
                   {k: v.clone() for k, v in self._carry.items()},
                   self._x.clone())
        if self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._one_step(*scratch)
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self._one_step(*scratch)
        del scratch

        def body():
            out, state, carry = self._one_step(self.state, self._carry,
                                               self._x)
            self._write(self.state, self._carry, state, carry)
            return out

        self._replay = None                 # free the old graph first
        before = ops.launch_counts()
        self._replay = self._capture(body)
        self._graph_launches = ops.take_back_launches(before)
        self._graph_key = self._capture_key()
        self._graph_program = self.program     # keeps the key's id unique
        self.graph_stats["captures"] += 1
        self.graph_stats["capture_s"] = time.perf_counter() - t0

    def _replay_step(self) -> torch.Tensor:
        """One replay of the captured step from the input buffer (capturing
        it again first if what it bakes in changed); returns the graph's
        output buffer, which the next replay overwrites."""
        if self._graph_key != self._capture_key():
            self._capture_step()
        out = self._replay()
        ops.add_launches(self._graph_launches)
        self.graph_stats["replays"] += 1
        return out

    def _mask(self, sids) -> torch.Tensor:
        """A ``[N]`` bool mask on the device, built without a host copy:
        a fill of each slot's element (``mask[sid] = True`` would copy the
        scalar from the host and synchronise on a CUDA device)."""
        mask = torch.zeros((self.n_streams,), dtype=torch.bool,
                           device=self.device)
        for sid in sids:
            mask[sid].fill_(True)
        return mask

    def _select(self, mask: torch.Tensor, cur, new):
        n = self.n_streams

        def sel(c, w):
            return torch.where(mask.reshape((n,) + (1,) * (c.dim() - 1)),
                               w, c)

        return _map2(sel, cur, new)

    def _merge_rows(self, dst_state, dst_carry, src_state, src_carry, mask):
        """Take ``src``'s slot rows where ``mask`` is True, ``dst``'s
        elsewhere (per-stream carry only; lifetime aggregates and Θ_h keep
        ``dst``'s values) — the snapshot/rollback primitive."""
        state = self._select(mask, dst_state, src_state)
        carry = dict(dst_carry)
        for k in self._PER_STREAM_KEYS:
            carry[k] = torch.where(mask, src_carry[k], dst_carry[k])
        carry["last_x"] = torch.where(mask[:, None], src_carry["last_x"],
                                      dst_carry["last_x"])
        return state, carry

    def _to_device(self, x, pinned: bool = False) -> torch.Tensor:
        """A frame on the engine's device. Host numpy input is snapshotted
        with a synchronous copy, so a caller may reuse its buffer at once;
        a CPU tensor goes to a CUDA device through pinned memory without
        blocking the host. With ``pinned`` it stays in that pinned memory,
        for a non-blocking copy into the input buffer."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x, np.float32))
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.device == self.device:
            return x
        if self.device.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory()
            return x if pinned else x.to(self.device, non_blocking=True)
        return x.to(self.device)

    # -- hot path ---------------------------------------------------------

    def step(self, x) -> torch.Tensor:
        """Process one timestep. ``x: [I]`` (single stream) or
        ``[n_streams, I]``; returns ``[O]`` / ``[n_streams, O]`` on the
        device. Reading the result (or :attr:`stats`) is what synchronises,
        not the call. The result is a tensor of its own: later steps do not
        overwrite it."""
        x = self._to_device(x, pinned=self._capture is not None)
        i_dim = self.dims.input_size
        if x.dim() == 1 and self.n_streams == 1:
            x = x[None]
        if tuple(x.shape) != (self.n_streams, i_dim):
            want = (f"[{i_dim}]" if self.n_streams == 1
                    else f"[{self.n_streams}, {i_dim}]")
            raise ValueError(
                f"engine has n_streams={self.n_streams}; step needs one "
                f"frame per stream slot, shape {want}"
                f"{f' or [1, {i_dim}]' if self.n_streams == 1 else ''}, "
                f"got {tuple(x.shape)} — reshaping would silently "
                "cross-contaminate stream slots")
        if self._capture is None:
            out = self._eager_step(x)
        else:
            self._x.copy_(x, non_blocking=True)
            out = self._replay_step().clone()
        self._n_steps += 1
        return out[0] if self.n_streams == 1 else out

    def _eager_step(self, x: torch.Tensor) -> torch.Tensor:
        """One step run op by op from ``x`` into the buffers (the CPU's
        step)."""
        out, state, carry = self._one_step(self.state, self._carry, x)
        self._write(self.state, self._carry, state, carry)
        return out

    def step_many(self, xs) -> torch.Tensor:
        """Process a chunk of timesteps. ``xs: [T, I]`` or
        ``[T, n_streams, I]``; returns ``[T, O]`` / ``[T, n_streams, O]``.
        One host-to-device copy for the chunk, then a loop of device steps
        with no host sync: on a CUDA device a replay a frame, each output
        copied into a ``[T, n_streams, O]`` tensor of its own (JAX's
        ``_steps`` is one ``lax.scan``; T varies, so one graph serves every
        chunk length)."""
        xs = self._to_device(xs)
        squeeze = xs.dim() == 2
        if squeeze:
            if self.n_streams != 1:
                raise ValueError(
                    f"engine has n_streams={self.n_streams}; step_many "
                    f"needs [T, {self.n_streams}, I], got {tuple(xs.shape)} "
                    "(a 2-D chunk would silently broadcast one stream's "
                    "input to all streams)")
            xs = xs[:, None, :]
        elif xs.shape[1] != self.n_streams:
            raise ValueError(
                f"chunk stream dim {xs.shape[1]} != n_streams="
                f"{self.n_streams} (xs: {tuple(xs.shape)})")
        if self._capture is None:
            outs = torch.stack([self._eager_step(x) for x in xs])
        else:
            outs = torch.empty((xs.shape[0], self.n_streams,
                                self.head[0].shape[-1]),
                               dtype=torch.float32, device=self.device)
            for x, out in zip(xs, outs):
                self._x.copy_(x)
                out.copy_(self._replay_step())
        self._n_steps += xs.shape[0]
        return outs[:, 0] if (squeeze and self.n_streams == 1) else outs

    # -- per-stream sessions ----------------------------------------------

    @property
    def free_streams(self) -> list:
        """Slot ids not currently claimed by an open session."""
        return [i for i, busy in enumerate(self._slot_busy) if not busy]

    def open_stream(self) -> int:
        """Claim a free slot: masked-reset only that slot's state and
        accounting. Raises ``RuntimeError`` when every slot is busy."""
        free = self.free_streams
        if not free:
            raise RuntimeError(
                f"all {self.n_streams} stream slots are busy; close one "
                "or queue through GruStreamBatcher")
        sid = free[0]
        mask = self._mask([sid])
        fresh = self.program.init_state((self.n_streams,))
        carry = dict(self._carry)
        for k in self._PER_STREAM_KEYS:
            carry[k] = torch.where(mask, 0.0, carry[k])
        carry["last_x"] = torch.where(mask[:, None], 0.0, carry["last_x"])
        self._write(self.state, self._carry,
                    self._select(mask, self.state, fresh), carry)
        self._slot_busy[sid] = True
        self._slot_opened_at[sid] = self._n_steps
        # the slot's rollback target starts as its fresh session state
        self.snapshot_streams([sid])
        return sid

    def host_carry(self) -> dict:
        """The per-stream accounting carry copied to the host (one copy,
        one sync)."""
        host = torch.stack([self._carry[k] for k in self._PER_STREAM_KEYS])
        return dict(zip(self._PER_STREAM_KEYS, host.cpu().numpy()))

    def close_stream(self, sid: int, host_carry=None) -> dict:
        """Release a session slot; returns that stream's accounting. One
        host sync, or none when the caller passes a :meth:`host_carry`
        fetched once for several closes."""
        if not (0 <= sid < self.n_streams) or not self._slot_busy[sid]:
            raise ValueError(f"stream {sid} is not open")
        host = host_carry if host_carry is not None else self.host_carry()
        steps = self._n_steps - self._slot_opened_at[sid]
        fired_x = float(host["fired_x"][sid])
        fired_h = float(host["fired_h"][sid])
        lat = float(host["lat_s"][sid])
        wb = float(host["w_bytes"][sid])
        self._slot_busy[sid] = False
        return {
            "stream": sid,
            "steps": steps,
            "gamma_dx": 1.0 - fired_x / max(steps, 1),
            "gamma_dh": 1.0 - fired_h / max(steps, 1),
            "est_latency_s": lat,
            "mean_est_latency_us": 1e6 * lat / max(steps, 1),
            "w_bytes": wb,
            "mean_weight_bytes_per_step": wb / max(steps, 1),
            "poison_steps": float(host["poison_steps"][sid]),
            "bad_state_steps": float(host["bad_state"][sid]),
        }

    # -- resilience: snapshot / rollback -----------------------------------

    def snapshot_streams(self, sids: list | None = None):
        """Copy the named slots' live rows into the rollback shadow
        (default: every open session). Device work only."""
        if sids is None:
            sids = [i for i, busy in enumerate(self._slot_busy) if busy]
        if not sids:
            return
        for sid in sids:
            if not (0 <= sid < self.n_streams):
                raise ValueError(f"stream {sid} out of range")
        self._write(self._snap_state, self._snap_carry, *self._merge_rows(
            self._snap_state, self._snap_carry, self.state, self._carry,
            self._mask(sids)))
        for sid in sids:
            self._snap_steps[sid] = self._n_steps - self._slot_opened_at[sid]

    def rollback_stream(self, sid: int) -> int:
        """Rewind one slot to its last snapshot (session start if none);
        returns the session-step index it rewinds to. Device work only."""
        if not (0 <= sid < self.n_streams) or not self._slot_busy[sid]:
            raise ValueError(f"stream {sid} is not open")
        self._write(self.state, self._carry, *self._merge_rows(
            self.state, self._carry, self._snap_state, self._snap_carry,
            self._mask([sid])))
        self._slot_opened_at[sid] = self._n_steps - self._snap_steps[sid]
        return self._snap_steps[sid]

    def set_theta_h(self, value: float):
        """Overwrite the live Θ_h (a device fill, no sync)."""
        if self._per_layer:
            raise ValueError(
                "set_theta_h adjusts one scalar theta_h, which would "
                "silently override the per-layer threshold policy")
        self._carry["theta_h"].fill_(value)

    # -- resilience: checkpoint / restore ----------------------------------

    def _ckpt_tree(self) -> dict:
        """The engine's restorable tree: the state, carry and shadow
        buffers, and the host slot bookkeeping as numpy leaves."""
        return {
            "state": self.state,
            "carry": self._carry,
            "snap_state": self._snap_state,
            "snap_carry": self._snap_carry,
            "meta": {
                "n_steps": np.int64(self._n_steps),
                "slot_busy": np.asarray(self._slot_busy, bool),
                "slot_opened_at": np.asarray(self._slot_opened_at,
                                             np.int64),
                "snap_steps": np.asarray(self._snap_steps, np.int64),
            },
        }

    def checkpoint(self, ckpt_dir: str, step: int | None = None) -> str:
        """Publish a crash-consistent engine checkpoint (atomic rename via
        :mod:`repro_torch.ft.checkpoint`): recurrent state, the accounting
        carry, the rollback shadows and slot bookkeeping, so
        :meth:`restore` resumes with the same streams and the same
        :meth:`report`. Syncs (the tree is copied to the host)."""
        step = self._n_steps if step is None else step
        return ft_checkpoint.save(ckpt_dir, step, self._ckpt_tree())

    @classmethod
    def restore(cls, ckpt_dir: str, program, task, step: int | None = None,
                **kwargs) -> "DeltaStreamEngine":
        """Rebuild an engine from :meth:`checkpoint` output (of this
        package or of the JAX engine).

        ``program`` / ``task`` / ``kwargs`` must match the checkpointing
        engine's construction (weights travel in the program, not the
        checkpoint); a shape that does not match raises in
        :func:`repro_torch.ft.checkpoint.restore`. The engine is built
        first (on a CUDA device it captures its graph), then the restored
        values are written into its buffers.
        """
        eng = cls(program, task, **kwargs)
        tree = ft_checkpoint.restore(ckpt_dir, eng._ckpt_tree(), step=step,
                                     device=eng.device)
        eng._write(eng.state, eng._carry, tree["state"], tree["carry"])
        eng._write(eng._snap_state, eng._snap_carry, tree["snap_state"],
                   tree["snap_carry"])
        meta = tree["meta"]
        eng._n_steps = int(meta["n_steps"])
        eng._slot_busy = [bool(b) for b in meta["slot_busy"]]
        eng._slot_opened_at = [int(v) for v in meta["slot_opened_at"]]
        eng._snap_steps = [int(v) for v in meta["snap_steps"]]
        return eng

    # -- accounting -------------------------------------------------------

    def _scalar(self, value: float) -> torch.Tensor:
        return torch.full((), value, dtype=torch.float32, device=self.device)

    @property
    def theta_h(self) -> float:
        """Current Θ_h (syncs once)."""
        return float(self._carry["theta_h"])

    @property
    def stats(self) -> StreamStats:
        """Copy the lifetime aggregates to the host once."""
        keys = ("agg_fired_x", "agg_fired_h", "agg_lat_s", "agg_w_bytes",
                "agg_ufired_x", "agg_ufired_h", "agg_tile_lat_s",
                "agg_tile_w_bytes", "agg_poison_steps", "agg_bad_state")
        host = torch.stack([self._carry[k] for k in keys]).cpu().tolist()
        v = dict(zip(keys, host))
        return StreamStats(
            steps=self._n_steps,
            fired_x=v["agg_fired_x"], fired_h=v["agg_fired_h"],
            est_latency_s=v["agg_lat_s"], w_bytes=v["agg_w_bytes"],
            ufired_x=v["agg_ufired_x"], ufired_h=v["agg_ufired_h"],
            tile_est_latency_s=v["agg_tile_lat_s"],
            tile_w_bytes=v["agg_tile_w_bytes"],
            poison_steps=v["agg_poison_steps"],
            bad_state_steps=v["agg_bad_state"],
        )

    def reset(self):
        """Every slot fresh, every count zero: written into the buffers
        (allocated at the first call), each carry key a tensor of its own."""
        fresh = self.program.init_state(batch_shape=(self.n_streams,))

        def zeros():
            return torch.zeros((self.n_streams,), dtype=torch.float32,
                               device=self.device)

        carry = {
            "fired_x": zeros(),
            "fired_h": zeros(),
            "lat_s": zeros(),
            "w_bytes": zeros(),
            "agg_fired_x": self._scalar(0.0),
            "agg_fired_h": self._scalar(0.0),
            "agg_lat_s": self._scalar(0.0),
            "agg_w_bytes": self._scalar(0.0),
            "agg_ufired_x": self._scalar(0.0),
            "agg_ufired_h": self._scalar(0.0),
            "agg_tile_lat_s": self._scalar(0.0),
            "agg_tile_w_bytes": self._scalar(0.0),
            "last_x": torch.zeros((self.n_streams, self.dims.input_size),
                                  dtype=torch.float32, device=self.device),
            "poison_steps": zeros(),
            "bad_state": zeros(),
            "agg_poison_steps": self._scalar(0.0),
            "agg_bad_state": self._scalar(0.0),
            "theta_h": self._scalar(self.thresholds.theta_h),
        }
        if self.state is None:
            self.state, self._snap_state = _clone(fresh), _clone(fresh)
            self._carry = carry
            self._snap_carry = {k: v.clone() for k, v in carry.items()}
        else:
            self._write(self.state, self._carry, fresh, carry)
            self._write(self._snap_state, self._snap_carry, fresh, carry)
        self._n_steps = 0
        self._slot_busy = [False] * self.n_streams
        self._slot_opened_at = [0] * self.n_streams
        self._snap_steps = [0] * self.n_streams

    def report(self) -> dict:
        s = self.stats
        est = estimate_stack(self.dims, s.gamma_dx, s.gamma_dh, self.accel)
        rep = {
            "steps": s.steps,
            "gamma_dx": s.gamma_dx,
            "gamma_dh": s.gamma_dh,
            "mean_est_latency_us": 1e6 * s.est_latency_s / max(s.steps, 1),
            "mean_weight_bytes_per_step": s.w_bytes / max(s.steps, 1),
            "weight_bits": self.accel.w_weight_bits,
            "effective_throughput_gops": est.throughput_ops / 1e9,
            "theta_x": self.theta_x,
            "theta_h": self.theta_h,
            "backend": self.backend,
            "cell": self.cell,
            "n_streams": self.n_streams,
            "weight_fetch": "tile" if self._tile_fetch else "stream",
            "poison_steps": s.poison_steps,
            "bad_state_steps": s.bad_state_steps,
        }
        if self._tile_fetch:
            steps = max(s.steps, 1)
            rep["union_gamma_dx"] = s.union_gamma_dx
            rep["union_gamma_dh"] = s.union_gamma_dh
            rep["tile_est_latency_us"] = 1e6 * s.tile_est_latency_s / steps
            rep["tile_weight_bytes_per_step"] = s.tile_w_bytes / steps
            rep["weight_bytes_per_stream_per_step"] = (
                s.tile_w_bytes / steps / self.n_streams)
        if self._per_layer:
            rep["theta_x"] = rep["theta_h"] = None
            rep["theta_x_per_layer"] = self._theta_x_layers
            rep["theta_h_per_layer"] = self._theta_h_layers
        return rep


# The class served only GRU programs when it was born; the name survives
# as an alias now that it streams any compiled delta-RNN cell.
GruStreamEngine = DeltaStreamEngine
