"""Serving engines, the PyTorch port of :mod:`repro.serve.engine`.

``LmEngine`` — batched prefill and decode for a registry arch over a fixed
slot count, with ring caches of per-slot lengths for continuous batching.
On a CUDA device both are the JAX engine's jitted programs as CUDA graphs
over the engine's caches: the decode step one graph over a ``[B, 1]``
token buffer, the prefill one graph a prompt signature (the tokens' shape
and each modality input's name, shape and dtype), over fixed input
buffers of that signature, captured at its first use as JAX traces its
jitted prefill once a shape. At most ``PREFILL_GRAPHS`` prefill graphs are
held, in one memory pool, the least recently used evicted first. On the
CPU both run eagerly.

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

The step is the port's ``jax.jit(_step)``, and ``step_many`` its
``jax.jit(_steps)``. The engine keeps its state, its carry and a chunk of
16 input frames and outputs in fixed buffers, and every step and session
call writes into them in place. On a CUDA device K steps over those
buffers are captured as one CUDA graph, for K in 1, 2, 4, 8 and 16: the
one-step graph at construction, the others at their first use, and all
of them again when a value they bake in changes (:meth:`_capture_key`).
``step`` replays the one-step graph; ``step_many`` copies a chunk of T
frames to the device once and replays T // 16 sixteen-step graphs and at
most one each of 8, 4, 2 and 1 steps (:func:`chunk_plan`); a capture or
replay that fails raises. On the CPU, where no graph exists, the same
step runs eagerly. ``graph_stats`` counts the captures, the replays and
the steps they ran.

The session calls are the reference's jitted ``_reset_streams`` and
``_merge_rows``, over two more buffers: the slot an open resets (a device
scalar) and a ``[N]`` row mask. ``open_stream`` is one fill of the slot and
one replay of a graph that builds the mask from it, puts the program's
fresh state (one slot's rows, built once per program) into the slot's rows,
zeroes its per-stream accounting and copies those rows into the rollback
shadow: the JAX engine's reset and snapshot dispatches in one.
``snapshot_streams`` / ``rollback_stream`` fill the mask and replay the
merge graph of their direction. These graphs are captured at their first
use, under the step graphs' capture key; ``session_stats`` counts them.

A step is the program's step (a Delta Unit launch and a layer kernel a
layer for the GRU / LSTM kernel backends: :func:`repro_torch.kernels.ops.
delta_unit`), the head and one epilogue launch that does the accounting
below and updates the carry in place (:func:`repro_torch.kernels.ops.
engine_epilogue`). The frame guard runs inside layer 0's Delta Unit launch
on the GRU / LSTM kernel backends (a frame of at most 256 columns); on the
others it is four small kernels before the step. The host thresholds are
the step's constants (:class:`repro_torch.core.delta.StepTheta`): at 0
every element fires, NaN included, as in the reference's jitted step.

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

import collections
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.delta import step_thetas
from repro_torch.core.perf_model import (EDGEDRNN, AcceleratorSpec,
                                         estimate_stack, spec_for_backend)
from repro_torch.core.program import (DeltaProgram, DeltaProgramState,
                                      compile_delta_program, infer_cell)
from repro_torch.core.sparsity import cell_dims
from repro_torch.core.thresholds import ThresholdPolicy, dynamic_threshold
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import current_mesh
from repro_torch.ft import checkpoint as ft_checkpoint
from repro_torch.kernels import ops
from repro_torch.kernels.delta_unit import (FrameGuard, count_rows_ref,
                                            guard_fits)
from repro_torch.kernels.engine_epilogue import (EpilogueConsts,
                                                 epilogue_workspace_words)
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.gru_rnn import GruTaskConfig
from repro_torch.models.lm import init_lm_caches, lm_decode, lm_prefill
from repro_torch.models.rglru import assoc_route
from repro_torch.models.rwkv import chunked_route


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


# the steps a captured graph runs, largest first (step_many's chunks)
CHUNK_STEPS = (16, 8, 4, 2, 1)


def chunk_plan(t: int) -> list:
    """The captured graphs that run ``t`` steps: ``t // 16`` of 16 steps,
    then at most one each of 8, 4, 2 and 1 (``ceil(t / 16) + 4`` replays
    at most)."""
    plan = [CHUNK_STEPS[0]] * (t // CHUNK_STEPS[0])
    rest = t % CHUNK_STEPS[0]
    for k in CHUNK_STEPS[1:]:
        if rest >= k:
            plan.append(k)
            rest -= k
    return plan


# The prefill graphs an LmEngine holds at once; the least recently used is
# evicted first. They share one memory pool, captured on one stream, so a
# capture reuses the blocks of the activations the others freed: the pool
# holds about one prefill's activations at the longest prompt held (the
# blocks free a layer's intermediates before the next), and a held graph
# adds its logits there and no device memory the driver keeps beside the
# caching allocator that an H100 run could see (PERF.md §5). A
# ContinuousBatcher captures one graph a distinct wave length, and a wave
# is as long as its longest prompt; a bound under the lengths a load
# cycles through evicts each graph before its length comes back, and
# every wave then pays a capture (PERF.md §5: a drain's second run at 8
# graphs replays 14 % of its waves, at 64 all). 128 hold every length of
# a load of prompts spread over up to 128 lengths (16-96 tokens: 81).
PREFILL_GRAPHS = 128


def _put(buf: torch.Tensor, x: torch.Tensor) -> None:
    """Copy ``x`` into the buffer ``buf`` without a host sync: a CPU tensor
    through pinned memory, a device tensor device to device. ``x`` must
    have ``buf``'s shape; it is cast to its dtype."""
    x = x.to(buf.dtype)
    if x.device.type == "cpu" and buf.device.type == "cuda":
        x = x.pin_memory()
    buf.copy_(x, non_blocking=True)


def _host_or_device(x) -> torch.Tensor:
    """``x`` as a tensor where it lies (a host array as a CPU tensor)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    return torch.as_tensor(x)


@dataclass
class _PrefillGraph:
    """One captured prefill: its replay, the launches a replay adds, its
    fixed input buffers, the host seconds of its warm-up (0 where none
    ran) and of its whole capture (the warm-up included), and its
    replays."""

    replay: object
    launches: tuple
    tokens: torch.Tensor
    inputs: dict
    warmup_s: float
    capture_s: float
    replays: int = 0


class LmEngine:
    """Prefill / decode engine over a fixed slot count (the decode batch).

    ``params`` (from :func:`repro_torch.models.lm.init_lm` or
    :func:`~repro_torch.models.lm.lm_params_from_numpy`) must lie on
    ``device`` (default ``"cuda"``), where the engine keeps its caches.
    Prefill and decode write the caches in place. On a CUDA device the
    decode step is a CUDA graph over the caches, a ``[B, 1]`` token buffer
    and the logits it writes, captured at construction; the prefill is one
    CUDA graph a prompt signature over the caches, a ``[B, S]`` token
    buffer and one buffer a modality input, captured at the signature's
    first use (at most ``PREFILL_GRAPHS`` held, in one memory pool,
    least recently used evicted). Every graph is captured again when a value it bakes in
    changes (:meth:`_capture_key`; a prefill graph also keys on the scan
    routes, :func:`repro_torch.models.rwkv.chunked_route` and
    :func:`repro_torch.models.rglru.assoc_route`); a capture or replay that
    fails raises. On the CPU both run eagerly. Assigning ``caches`` (the
    JAX engine's style) copies the new values into the engine's buffers,
    leaf by leaf: a captured graph reads those buffers, and would not see a
    tree put in their place."""

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
        self._caches = init_lm_caches(cfg, batch, max_len, self.device)
        self._tokens = torch.zeros((batch, 1), dtype=torch.int64,
                                   device=self.device)
        # the captured decode step and prefills: on a CUDA device only
        self._capture = (ops.capture_cuda_graph if self.device.type == "cuda"
                         else None)
        self._decode = None     # (replay, launches of a replay)
        self._decode_key = self._decode_refs = None
        self.decode_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
        # signature -> _PrefillGraph, least recently used first; the
        # prefill graphs' one capture stream; the warm-ups run
        self._prefill = collections.OrderedDict()
        self._prefill_key = self._prefill_refs = None
        self._prefill_stream = (torch.cuda.Stream(self.device)
                                if self._capture is not None else None)
        self._prefill_warm = set()
        self.prefill_stats = {"captures": 0, "capture_s": 0.0, "replays": 0,
                              "evictions": 0, "held": 0}
        if self._capture is not None:
            self._capture_decode()

    @property
    def caches(self) -> list:
        return self._caches

    @caches.setter
    def caches(self, new) -> None:
        if new is self._caches:
            return
        dst, src = tree_leaves(self._caches), tree_leaves(new)
        if len(dst) != len(src) or any(
                d.shape != s.shape or d.dtype != s.dtype
                for d, s in zip(dst, src)):
            raise ValueError(
                "caches: the new tree's leaves differ from the engine's in "
                "number, shape or dtype; build them with init_lm_caches("
                "cfg, batch, max_len)")
        _copy_into(dst, src)

    def _capture_key(self) -> tuple:
        """What the captured graphs bake in: the batch and ring sizes, the
        config, the parameters (by identity: a tree whose leaves are
        replaced must be a new tree) and the mesh, on which the blocks
        branch when they run (``lm._embed``, ``moe.moe_apply``)."""
        return (self.batch, self.max_len, self.cfg, id(self.params),
                id(current_mesh()))

    @torch.no_grad()
    def _capture_decode(self) -> None:
        """Capture one decode step over the buffers with ``self._capture``.
        One step first runs on a scratch copy of the caches on a side
        stream, so what runs at first use (cuBLAS's handle and workspace,
        kernel builds and launch plans) runs outside the capture and the
        caches stay as they were; its launches ran and stay counted. The
        capture calls the kernel wrappers once and runs no kernel: their
        counts are taken back and added again at each replay."""
        t0 = time.perf_counter()
        self._decode = None                 # free the old graph first
        ops.run_aside(self.device, lm_decode, self.params, self.cfg,
                   self._tokens.clone(), tree_map(torch.clone, self._caches))

        def body():
            logits, _ = lm_decode(self.params, self.cfg, self._tokens,
                                  self._caches)
            return logits

        before = ops.launch_counts()
        replay = self._capture(body)
        self._decode = (replay, ops.take_back_launches(before))
        self._decode_key = self._capture_key()
        # keeps the ids in the key unique while the graph lives
        self._decode_refs = (self.params, current_mesh())
        self.decode_stats["captures"] += 1
        self.decode_stats["capture_s"] = time.perf_counter() - t0

    def _capture_prefill(self, sig: tuple, tokens: torch.Tensor,
                         modality: dict) -> _PrefillGraph:
        """Capture the prefill of signature ``sig`` over new input buffers
        holding ``tokens`` and ``modality``, into the pool of the graphs
        held, on the prefill graphs' stream. The least recently used graphs
        go first, down to ``PREFILL_GRAPHS - 1``. As in
        :meth:`_capture_decode`, a prefill first runs on a scratch copy of
        the caches on a side stream, its launches counted, so first-use
        work runs outside the capture; it runs once a signature but for
        the prompt's length (the modality inputs and the scan routes: what
        runs), as a prompt of a new length calls the ops of the last. The
        capture's launches are taken back and added again at each
        replay."""
        t0 = time.perf_counter()
        while len(self._prefill) >= PREFILL_GRAPHS:
            self._prefill.popitem(last=False)
            self.prefill_stats["evictions"] += 1
        tok_buf = torch.empty(tokens.shape, dtype=torch.int64,
                              device=self.device)
        _put(tok_buf, tokens)
        bufs = {}
        for name, x in modality.items():
            bufs[name] = torch.empty(x.shape, dtype=x.dtype,
                                     device=self.device)
            _put(bufs[name], x)
        warmup_s = 0.0
        if sig[1:] not in self._prefill_warm:
            t1 = time.perf_counter()
            ops.run_aside(self.device, lambda: lm_prefill(
                self.params, self.cfg, tok_buf,
                tree_map(torch.clone, self._caches), **bufs))
            self._prefill_warm.add(sig[1:])
            warmup_s = time.perf_counter() - t1

        def body():
            logits, _ = lm_prefill(self.params, self.cfg, tok_buf,
                                   self._caches, **bufs)
            return logits

        pool = next((getattr(g.replay, "pool", None)
                     for g in self._prefill.values()), None)
        before = ops.launch_counts()
        replay = self._capture(body, pool=pool, stream=self._prefill_stream)
        graph = _PrefillGraph(replay, ops.take_back_launches(before),
                              tok_buf, bufs, warmup_s,
                              time.perf_counter() - t0)
        self._prefill[sig] = graph
        self.prefill_stats["captures"] += 1
        self.prefill_stats["capture_s"] += graph.capture_s
        self.prefill_stats["held"] = len(self._prefill)
        return graph

    @torch.no_grad()
    def prefill(self, tokens, **modality) -> torch.Tensor:
        """Prefill all slots with (left-padded) prompts ``[B, S]``; returns
        the last logits ``[B, 1, V]``, a tensor of its own. The VLM takes
        ``image_embeds=``, the encoder-decoder ``audio_frames=`` (arrays in
        the model's dtype). On a CUDA device the inputs go into the
        buffers of their signature's graph without a host sync (host arrays
        through pinned memory), then one replay; a new signature captures
        its graph first."""
        if self._capture is None:
            logits, _ = lm_prefill(
                self.params, self.cfg,
                torch.as_tensor(tokens, device=self.device), self._caches,
                **{k: torch.as_tensor(v, device=self.device)
                   for k, v in modality.items()})
            return logits
        tokens = _host_or_device(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != self.batch:
            raise ValueError(f"prefill takes a prompt a slot, [{self.batch}, "
                             f"S]; got {tuple(tokens.shape)}")
        modality = {k: _host_or_device(v)
                    for k, v in sorted(modality.items())}
        if self._prefill_key != self._capture_key():
            self._prefill.clear()
            self._prefill_warm.clear()
            self.prefill_stats["held"] = 0
            self._prefill_key = self._capture_key()
            # keeps the ids in the key unique while the graphs live
            self._prefill_refs = (self.params, current_mesh())
        sig = (tuple(tokens.shape),
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in modality.items()),
               chunked_route(), assoc_route())
        graph = self._prefill.get(sig)
        if graph is None:
            graph = self._capture_prefill(sig, tokens, modality)
        else:
            self._prefill.move_to_end(sig)
            _put(graph.tokens, tokens)
            for name, x in modality.items():
                _put(graph.inputs[name], x)
        logits = graph.replay()
        ops.add_launches(graph.launches)
        graph.replays += 1
        self.prefill_stats["replays"] += 1
        # the graphs share a pool: another's replay may overwrite this
        # one's logits, so they are copied out (on the stream of the
        # replay, ahead of any later one) before the call returns
        return logits.clone()

    def prefill_graphs(self) -> dict:
        """The prefill graphs held, least recently used first: per
        signature its warm-up's and its capture's seconds (the capture's
        body and end, ``capture_cuda_graph``'s ``split``, where it has
        one), its replays, its memory pool's id and that pool's bytes (the
        caching allocator's segments of the pool, which the graphs share,
        ``torch.cuda.memory_snapshot()``; ``None`` where the snapshot does
        not name the pools, or the capture has no pool)."""
        sizes = None
        if self.device.type == "cuda" and self._prefill:
            segments = torch.cuda.memory_snapshot()
            if all("segment_pool_id" in seg for seg in segments):
                sizes = collections.Counter()
                for seg in segments:
                    sizes[tuple(seg["segment_pool_id"])] += seg["total_size"]
        out = {}
        for sig, graph in self._prefill.items():
            pool = getattr(graph.replay, "pool", None)
            out[sig] = {"warmup_s": graph.warmup_s,
                        "capture_s": graph.capture_s,
                        **getattr(graph.replay, "split", {}),
                        "replays": graph.replays, "pool": pool,
                        "pool_bytes": (None if sizes is None or pool is None
                                       else sizes[pool])}
        return out

    @torch.no_grad()
    def decode_step(self, tokens) -> torch.Tensor:
        """One decode step for every slot, ``tokens: [B, 1]``; returns the
        logits ``[B, 1, V]``, a tensor of its own (later steps do not
        overwrite it). On a CUDA device the tokens go into the token buffer
        without a host sync (a host array through pinned memory, a device
        tensor device to device), then one replay."""
        if self._capture is None:
            logits, _ = lm_decode(
                self.params, self.cfg,
                torch.as_tensor(tokens, device=self.device), self._caches)
            return logits
        tokens = _host_or_device(tokens)
        if tuple(tokens.shape) != (self.batch, 1):
            raise ValueError(f"decode_step takes one token a slot, "
                             f"[{self.batch}, 1]; got {tuple(tokens.shape)}")
        _put(self._tokens, tokens)
        if self._decode_key != self._capture_key():
            self._capture_decode()
        replay, launches = self._decode
        logits = replay()
        ops.add_launches(launches)
        self.decode_stats["replays"] += 1
        return logits.clone()

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
        # the fixed buffers: a chunk of frames and outputs (the one-step
        # graph reads the first frame and writes the first output), the
        # epilogue's workspace, and the state and carry (and their rollback
        # shadows) from reset
        self._xs = torch.zeros((CHUNK_STEPS[0], n_streams, task.input_size),
                               dtype=torch.float32, device=self.device)
        self._x = self._xs[0]
        self._ys = torch.zeros((CHUNK_STEPS[0], n_streams,
                                program.head.shape[-1]),
                               dtype=torch.float32, device=self.device)
        self._epilogue_ws = torch.zeros(
            (epilogue_workspace_words(n_streams, program.num_layers),),
            dtype=torch.int32, device=self.device)
        self._finite = torch.ones((n_streams,), dtype=torch.bool,
                                  device=self.device)
        self._epilogue_consts = EpilogueConsts(
            self.dims, self.accel.k_pes * self.accel.f_pl_hz,
            self.accel.w_weight_bits)
        # the session programs' buffers: the slot an open resets, the [N]
        # row mask the programs read, and the fresh state of one slot
        self._slot = torch.zeros((), dtype=torch.int64, device=self.device)
        self._slot_ids = torch.arange(n_streams, device=self.device)
        self._rows = torch.zeros((n_streams,), dtype=torch.bool,
                                 device=self.device)
        self._fresh = self._fresh_program = None
        self.state = None
        self.reset()
        # the captured steps: on a CUDA device only (the CPU steps eagerly)
        self._capture = (ops.capture_cuda_graph if self.device.type == "cuda"
                         else None)
        self._graphs = {}       # steps K -> (replay, launches of a replay)
        self.capture_s = {}     # steps K -> seconds its last capture took
        self._sessions = {}     # session program -> (replay, launches)
        self._graph_key = self._graph_program = None
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0,
                            "steps": 0}
        self.session_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
        if self._capture is not None:
            self._capture_step()

    # -- the step (tensor ops only: no host sync) --------------------------

    @property
    def guard_folds(self) -> bool:
        """True when layer 0's Delta Unit launch runs the frame guard: a
        backend whose step takes it (the GRU / LSTM kernel backends) at a
        frame width and slot count that one block takes in one turn
        (``guard_fits``: at I = 40, N <= 64)."""
        return (self.program.spec.frame_guard
                and guard_fits(self.n_streams, self.dims.input_size))

    def _one_step(self, state, carry: dict, x: torch.Tensor, out=None):
        """One timestep with the frame guard, firing statistics, Eq. 7
        terms and the Θ controller, all on the device. ``carry`` is updated
        in place and returned; the output goes to ``out`` when given."""
        # the host thresholds are constants of the step, as in the
        # reference's jitted step; theta_h of the carry is a buffer
        tx = step_thetas(self._theta_x_layers if self._per_layer
                         else self.theta_x)
        th = (step_thetas(self._theta_h_layers) if self._per_layer
              else carry["theta_h"])
        if self.guard_folds:
            # layer 0's Delta Unit guards the raw frame, writing finite and
            # the guarded frame (into last_x) in the same pass
            finite = self._finite
            y, new_state, deltas = self.program.step(
                state, x, tx, th, guard=FrameGuard(carry["last_x"], finite))
            x = None
        else:
            # x - x is 0 exactly where x is finite (NaN where it is not),
            # two kernels where torch.isfinite takes four
            finite = torch.all(x - x == 0, dim=-1)                # [N]
            x = torch.where(finite[:, None], x, carry["last_x"])
            y, new_state, deltas = self.program.step(state, x, tx, th)
        out = torch.add(y @ self.head[0], self.head[1], out=out)
        # the Delta Unit's counts (a layer that encoded without it, on a
        # dense backend, is counted from its deltas)
        counts = [(layer, rows) for layer, d in enumerate(deltas)
                  for rows in (d.counts or (count_rows_ref([d[0]], [d[1]]),))]
        fh_mean = ops.engine_epilogue(
            list(_leaves(new_state.stack)), counts,
            [(dx.shape[-1], dh.shape[-1]) for dx, dh in deltas], carry, x,
            finite, self._epilogue_consts, self._epilogue_ws)
        if self.dynamic_target is not None:
            carry["theta_h"].copy_(dynamic_threshold(
                carry["theta_h"], fh_mean, self.dynamic_target))
        return out, new_state, carry

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

    def _capture_step(self, k: int = 1, session: str | None = None):
        """Capture ``k`` steps over the buffers with ``self._capture``:
        step ``j`` reads frame ``_xs[j]`` and writes output ``_ys[j]``; with
        ``session`` (and ``k = 0``) the graph is that session program
        (:meth:`_session`) instead. A changed :meth:`_capture_key` drops
        every graph first (each is captured again at its next use). The
        graph's work first runs on scratch copies of the buffers, so what
        runs on first use (kernel builds, launch plans, cuBLAS's handle and
        workspace) runs outside the capture and no stream advances; those
        launches ran and stay counted. The capture calls every kernel
        wrapper ``k`` times and runs no kernel: its counts are taken back
        and added again at each replay."""
        t0 = time.perf_counter()
        if self._graph_key != self._capture_key():
            self._graphs.clear()            # free the old graphs first
            self._sessions.clear()
        graphs = self._graphs if session is None else self._sessions
        graphs.pop(session or k, None)
        carry = {key: v.clone() for key, v in self._carry.items()}
        if session is None:
            ops.run_aside(self.device, self._one_step, _clone(self.state),
                          carry, self._x.clone())
        else:
            ops.run_aside(self.device, self._session, session,
                          _clone(self.state), carry, _clone(self._snap_state),
                          {key: v.clone()
                           for key, v in self._snap_carry.items()},
                          self._rows.clone(), self._slot.clone())
        del carry

        def body():
            if session is not None:
                self._session(session, self.state, self._carry,
                              self._snap_state, self._snap_carry, self._rows,
                              self._slot)
            for j in range(k):
                _, state, carry = self._one_step(
                    self.state, self._carry, self._xs[j], out=self._ys[j])
                self._write(self.state, self._carry, state, carry)
            return self._ys[:k]

        before = ops.launch_counts()
        replay = self._capture(body)
        graphs[session or k] = (replay, ops.take_back_launches(before))
        self._graph_key = self._capture_key()
        self._graph_program = self.program     # keeps the key's id unique
        stats = self.graph_stats if session is None else self.session_stats
        stats["captures"] += 1
        stats["capture_s"] = time.perf_counter() - t0
        if session is None:
            self.capture_s[k] = stats["capture_s"]

    def _replay_steps(self, k: int = 1) -> None:
        """One replay of the ``k``-step graph from the frame buffer into the
        output buffer ``_ys[:k]`` (capturing it first at its first use, or
        when what it bakes in changed)."""
        if self._graph_key != self._capture_key() or k not in self._graphs:
            self._capture_step(k)
        replay, launches = self._graphs[k]
        replay()
        ops.add_launches(launches)
        self.graph_stats["replays"] += 1
        self.graph_stats["steps"] += k

    # -- the session programs (tensor ops only: no host sync) --------------

    def _fresh_state(self) -> DeltaProgramState:
        """The program's fresh state for one slot, ``init_state((1,))``,
        built once per program: its rows are those of ``init_state((N,))``
        (each backend's ``m_init`` convention is the same for every slot)."""
        if self._fresh_program is not self.program:
            self._fresh = self.program.init_state((1,))
            self._fresh_program = self.program
        return self._fresh

    @staticmethod
    def _where_rows(rows: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> None:
        """``dst``'s slot rows where ``rows`` is True become ``src``'s (a
        row of one slot broadcasts), in place."""
        torch.where(rows.reshape((-1,) + (1,) * (dst.dim() - 1)), src, dst,
                    out=dst)

    def _reset_rows(self, state, carry: dict, rows: torch.Tensor) -> None:
        """The reference's ``_reset_streams``, in place: the fresh state in
        the slots where ``rows`` is True, their per-stream accounting and
        ``last_x`` zeroed; every other slot untouched."""
        for cur, new in zip(_leaves(state.stack),
                            _leaves(self._fresh_state().stack)):
            self._where_rows(rows, new, cur)
        for k in self._PER_STREAM_KEYS:
            carry[k].masked_fill_(rows, 0.0)
        carry["last_x"].masked_fill_(rows[:, None], 0.0)

    def _merge_rows(self, dst_state, dst_carry: dict, src_state,
                    src_carry: dict, rows: torch.Tensor) -> None:
        """The reference's ``_merge_rows``, in place: ``src``'s slot rows
        into ``dst`` where ``rows`` is True (per-stream carry and
        ``last_x`` only; the lifetime aggregates and Θ_h keep ``dst``'s
        values), the snapshot and rollback primitive."""
        for d, s in zip(_leaves(dst_state.stack), _leaves(src_state.stack)):
            self._where_rows(rows, s, d)
        for k in self._PER_STREAM_KEYS + ("last_x",):
            self._where_rows(rows, src_carry[k], dst_carry[k])

    def _session(self, name: str, state, carry: dict, snap_state,
                 snap_carry: dict, rows: torch.Tensor,
                 slot: torch.Tensor) -> None:
        """The session program ``name`` over the given buffers, in place.
        ``"reset"``: the rows of slot ``slot`` (``rows`` is written from
        it) reset; ``"open"``: that reset, then those rows into the shadow
        (the JAX engine's open: its reset and snapshot dispatches);
        ``"snapshot"`` / ``"rollback"``: the rows ``rows`` selects, live
        into shadow / shadow into live."""
        if name in ("open", "reset"):
            torch.eq(self._slot_ids, slot, out=rows)
            self._reset_rows(state, carry, rows)
        if name in ("open", "snapshot"):
            self._merge_rows(snap_state, snap_carry, state, carry, rows)
        elif name == "rollback":
            self._merge_rows(state, carry, snap_state, snap_carry, rows)

    def _run_session(self, name: str) -> None:
        """Run the session program ``name`` over the engine's buffers: one
        replay of its graph on a CUDA device (captured at its first use, or
        when what it bakes in changed), eagerly on the CPU."""
        if self._capture is None:
            self._session(name, self.state, self._carry, self._snap_state,
                          self._snap_carry, self._rows, self._slot)
            return
        if self._graph_key != self._capture_key() or name not in \
                self._sessions:
            self._capture_step(0, session=name)
        replay, launches = self._sessions[name]
        replay()
        ops.add_launches(launches)
        self.session_stats["replays"] += 1

    def _select_rows(self, sids) -> None:
        """Fill the row mask buffer with the slots ``sids``, without a host
        copy: a fill of each slot's element (``mask[sid] = True`` would copy
        the scalar from the host and synchronise on a CUDA device)."""
        self._rows.zero_()
        for sid in sids:
            self._rows[sid].fill_(True)

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
            self._replay_steps(1)
            out = self._ys[0].clone()
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
        One host-to-device copy for the chunk, then device steps with no
        host sync: on a CUDA device the replays of :func:`chunk_plan`
        (JAX's ``_steps`` is one ``lax.scan``), each taking its frames from
        the chunk and leaving its outputs in a ``[T, n_streams, O]`` tensor
        of its own."""
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
            t = 0
            for k in chunk_plan(xs.shape[0]):
                self._xs[:k].copy_(xs[t:t + k])
                self._replay_steps(k)
                outs[t:t + k].copy_(self._ys[:k])
                t += k
        self._n_steps += xs.shape[0]
        return outs[:, 0] if (squeeze and self.n_streams == 1) else outs

    # -- per-stream sessions ----------------------------------------------

    @property
    def free_streams(self) -> list:
        """Slot ids not currently claimed by an open session."""
        return [i for i, busy in enumerate(self._slot_busy) if not busy]

    def open_stream(self) -> int:
        """Claim a free slot: masked-reset only that slot's state and
        accounting, and make that fresh session state its rollback target
        (one fill of the slot buffer, one replay). Raises ``RuntimeError``
        when every slot is busy."""
        return self._open_stream(snapshot=True)

    def _open_stream(self, snapshot: bool) -> int:
        """Claim the first free slot. Without ``snapshot`` its rollback
        shadow keeps what it held (the reset replay alone: the JAX fleet's
        open, whose fleet has no rollback)."""
        free = self.free_streams
        if not free:
            raise RuntimeError(
                f"all {self.n_streams} stream slots are busy; close one "
                "or queue through GruStreamBatcher")
        sid = free[0]
        self._slot.fill_(sid)
        self._run_session("open" if snapshot else "reset")
        self._slot_busy[sid] = True
        self._slot_opened_at[sid] = self._n_steps
        if snapshot:
            self._snap_steps[sid] = 0
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
        self._select_rows(sids)
        self._run_session("snapshot")
        for sid in sids:
            self._snap_steps[sid] = self._n_steps - self._slot_opened_at[sid]

    def rollback_stream(self, sid: int) -> int:
        """Rewind one slot to its last snapshot (session start if none);
        returns the session-step index it rewinds to. Device work only."""
        if not (0 <= sid < self.n_streams) or not self._slot_busy[sid]:
            raise ValueError(f"stream {sid} is not open")
        self._select_rows([sid])
        self._run_session("rollback")
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
