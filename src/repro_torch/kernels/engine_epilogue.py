"""The streaming engine's step epilogue in one launch.

After the head, a :class:`repro_torch.serve.engine.DeltaStreamEngine` step
accounts for what it ran (the JAX engine's ``_one_step``, one XLA program
with the rest of its step):

* the per-slot flag of a non-finite value in any leaf of the new state;
* the per-slot firing fractions, each layer's nonzero deltas over its
  columns averaged over the layers, and the tile's union fractions;
* the Eq. 5-8 terms of both (the modelled latency and weight bytes);
* the carry: per-slot sums, lifetime aggregates, ``last_x``,
  ``poison_steps`` and ``bad_state``, updated in place.

:func:`engine_epilogue` takes the Delta Unit's count rows
(:mod:`repro_torch.kernels.delta_unit`) for the firing, and returns the
slots' mean hidden firing fraction, the dynamic Θ controller's input (the
controller itself stays in plain ops). CUDA operands launch
``csrc/engine_epilogue.cu``; CPU (and meta) operands run
:func:`engine_epilogue_ref`, the ops the engine ran before the kernel
existed, in the same order. The launch's tables of leaves, count tensors
and layers (:func:`epilogue_table`) lie in device memory: written once
after a capture in a CUDA graph (:func:`repro_torch.kernels.ops.
table_after_capture`), by a pinned copy on the stream in an eager call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (ENGINE_EPILOGUE_F32, cuda_stream,
                                     device_table, launches_kernel, require)

# Constants of csrc/engine_epilogue.cu.
EP_CHUNK = 4096          # elements of a leaf row a scan item
EP_GROUP = 4             # scan items a scanner has in flight
EP_MAX_N = 1024          # stream slots
EP_GRID = 264            # blocks at most: 2 an SM of an H100
EP_MAX_SMEM = 227 * 1024  # shared memory a block may take
EP_PER = 6               # per-slot carry entries
LEAF_WORDS = 4           # a leaf's table row: ptr, row, ld, item0 * 2 + vec
COUNT_WORDS = 4          # a count tensor's: ptr, rows, layer, entry0

PER_STREAM = ("fired_x", "fired_h", "lat_s", "w_bytes", "poison_steps",
              "bad_state")
AGGREGATES = ("agg_fired_x", "agg_fired_h", "agg_lat_s", "agg_w_bytes",
              "agg_ufired_x", "agg_ufired_h", "agg_tile_lat_s",
              "agg_tile_w_bytes", "agg_poison_steps", "agg_bad_state")


class EpilogueConsts(NamedTuple):
    """What the Eq. 7 terms need of the engine: its stack dims
    (:class:`repro_torch.core.sparsity.GruDims`), the MAC rate
    ``k_pes * f_pl_hz`` and the streamed weight bits."""

    dims: object
    rate: float
    w_bits: int


class EpilogueTable(NamedTuple):
    """The launch's tables as int64 words (:func:`epilogue_table`), with
    the counts the kernel takes beside them."""

    words: np.ndarray   # leaves, then count tensors, then layers
    n_leaves: int
    n_counts: int
    items: int          # the leaves' scan items (N * chunks of a row)
    entries: int        # the count tensors' rows * (N + 1)
    views: list         # the leaves as [N, row] views (kept alive)


def epilogue_table(leaves, counts, cols, n: int) -> EpilogueTable:
    """The kernel's tables of one step, built on the host from the
    operands' pointers, shapes and strides (any device):

    * a leaf ``[N, ...]`` a row of :data:`LEAF_WORDS`: its data pointer (a
      view ``[N, row]`` of it), its row length, its row stride, and its
      first scan item times two plus 1 when its rows start on 16 bytes
      (``N * ceil(row / 4096)`` items a leaf, in order);
    * a count tensor ``[rows, N + 2]`` (int32) a row of
      :data:`COUNT_WORDS`, in layer order: pointer, rows, layer and first
      entry (``rows * (N + 1)`` entries a tensor, in order);
    * a layer a word of two fp32: 1 / its input columns (low half), 1 / its
      hidden columns (high half), 0 for none.
    """
    n_layers = len(cols)
    words, views, items = [], [], 0
    for j, leaf in enumerate(leaves):
        if leaf.dtype != torch.float32 or leaf.dim() < 1 \
                or leaf.shape[0] != n:
            raise ValueError(f"state leaf {j}: want fp32 [{n}, ...], got "
                             f"{leaf.dtype} {tuple(leaf.shape)}")
        row = leaf.numel() // n
        v = leaf.reshape(n, row)          # a view wherever the rows allow
        if row > 1 and v.stride(1) != 1:
            v = v.contiguous()
        views.append(v)
        ld = v.stride(0) if row else 0
        vec = v.data_ptr() % 16 == 0 and ld % 4 == 0
        words += [v.data_ptr(), row, ld, 2 * items + int(vec)]
        items += n * -(-row // EP_CHUNK)
    if items >= 1 << 30:
        raise ValueError(f"engine_epilogue scans at most 2**30 chunks of "
                         f"{EP_CHUNK} elements, got {items}")
    entries = 0
    ordered = sorted(counts, key=lambda lc: lc[0])
    for layer, c in ordered:
        if not 0 <= layer < n_layers:
            raise ValueError(f"count rows of layer {layer}: the engine has "
                             f"{n_layers} layers")
        if c.dtype != torch.int32 or c.dim() != 2 or c.shape[1] != n + 2 \
                or not c.is_contiguous():
            raise ValueError(f"counts of layer {layer}: want contiguous "
                             f"int32 [rows, {n + 2}], got {c.dtype} "
                             f"{tuple(c.shape)}")
        words += [c.data_ptr(), c.shape[0], layer, entries]
        entries += c.shape[0] * (n + 1)
    inv = np.array([1.0 / w if w else 0.0 for pair in cols for w in pair],
                   dtype=np.float32)
    table = np.concatenate([np.array(words, dtype=np.int64),
                            inv.view(np.int64)])
    return EpilogueTable(table, len(leaves), len(ordered), items, entries,
                         views)


def epilogue_grid(items: int) -> int:
    """Blocks of a launch: block 0 and a scanner a scan item, at least one
    and at most ``EP_GRID - 1``."""
    return 1 + max(1, min(EP_GRID - 1, items))


def epilogue_smem_bytes(n_layers: int, n: int, n_leaves: int,
                        n_counts: int) -> int:
    """Shared memory of a block: the leaf and count tables (the
    scanners'), block 0's layers' 1 / columns, integer sums (then the
    tree's terms) and fractions."""
    sums = max(n_layers * 2 * (n + 1), EP_PER * n)
    return ((n_leaves * LEAF_WORDS + n_counts * COUNT_WORDS + n_layers) * 8
            + 4 * sums + 4 * 2 * (n + 1))


def epilogue_workspace_words(n: int, n_layers: int) -> int:
    """Int32 words of the launch's workspace (zeros, left zero): the
    slots' flags, the ticket and the count sums (``[N]``, ``[1]``,
    ``[L, 2, N + 1]``)."""
    return n + 1 + 2 * n_layers * (n + 1)


def engine_epilogue(leaves, counts, cols, carry: dict, x, finite:
                    torch.Tensor, consts: EpilogueConsts,
                    workspace: torch.Tensor | None = None) -> torch.Tensor:
    """Account for one engine step and update ``carry`` in place.

    Args:
      leaves: every tensor of the new state, each ``[N, ...]``.
      counts: ``(layer, count rows)`` pairs in layer order, the rows of
        the Delta Unit launches of each layer (one or more a layer).
      cols: per layer ``(input columns, hidden columns)``.
      carry: the engine's carry (every key but ``theta_h`` is written).
      x: the guarded frame ``[N, I]`` (becomes ``last_x``), or None when
        ``last_x`` already holds it (the frame guard ran in layer 0's Delta
        Unit).
      finite: ``[N]`` bool, the frame guard's verdict (``poison = 1 -
        finite``).
      consts: :class:`EpilogueConsts`.
      workspace: CUDA only: int32 zeros of
        :func:`epilogue_workspace_words`, left zero by the launch
        (allocated zeroed for the call when None).

    Returns the 0-d mean over the slots of the hidden firing fraction.
    """
    operands = [finite, *leaves, *(c for _, c in counts), *carry.values()]
    if x is not None:
        operands.append(x)
    if not launches_kernel(*operands):
        return engine_epilogue_ref(leaves, counts, cols, carry, x, finite,
                                   consts)
    return _launch(leaves, counts, cols, carry, x, finite, consts,
                   workspace)


def _fn():
    fn = _build.load("engine_epilogue.cu").engine_epilogue_f32
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci, ci, ci, ci, ci, ci, ci,
                       vp, cf, cf, cf, cf, cf, cf,
                       vp, ci, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(leaves, counts, cols, carry, x, finite, consts, workspace):
    f32 = torch.float32
    n = finite.shape[0]
    n_layers = len(cols)
    i_dim = carry["last_x"].shape[-1]
    if not 0 < n <= EP_MAX_N or not counts:
        raise ValueError(f"engine_epilogue takes 1 to {EP_MAX_N} slots and "
                         f"at least one count tensor; got {n}, {len(counts)}")
    smem = epilogue_smem_bytes(n_layers, n, len(leaves), len(counts))
    if smem > EP_MAX_SMEM:
        raise ValueError(
            f"engine_epilogue at {n} slots, {n_layers} layers, "
            f"{len(leaves)} leaves and {len(counts)} count tensors needs "
            f"{smem} B of shared memory; a block has {EP_MAX_SMEM}")
    require(finite, "finite", torch.bool, (n,), align=1)
    if x is not None:
        require(x, "x", f32, (n, i_dim), align=4)
    for k in PER_STREAM:
        require(carry[k], k, f32, (n,), align=4)
    for k in AGGREGATES:
        require(carry[k], k, f32, (), align=4)
    require(carry["last_x"], "last_x", f32, (n, i_dim), align=4)
    table = epilogue_table(leaves, counts, cols, n)
    dev = finite.device
    dev_table = device_table(table.words, dev)
    grid = epilogue_grid(table.items)
    fh_mean = torch.empty((), dtype=f32, device=dev)
    words = epilogue_workspace_words(n, n_layers)
    if workspace is None:
        workspace = torch.zeros((words,), dtype=torch.int32, device=dev)
    require(workspace, "workspace", torch.int32, (words,), align=4)
    io = [None if x is None else x.data_ptr(), finite.data_ptr(),
          carry["last_x"].data_ptr()]
    io += [carry[k].data_ptr() for k in PER_STREAM + AGGREGATES]
    io += [fh_mean.data_ptr(), workspace.data_ptr()]
    dims = consts.dims
    err = _fn()(
        n, i_dim, n_layers, table.n_leaves, table.n_counts, table.items,
        table.entries, dev_table.data_ptr(), 1.0 / n_layers, 1.0 / n,
        float(dims.x_weight_volume), float(dims.h_weight_volume),
        1.0 / consts.rate, float(consts.w_bits),
        (ctypes.c_uint64 * len(io))(*[p or 0 for p in io]), grid,
        cuda_stream(finite))
    if err:
        raise RuntimeError(f"{ENGINE_EPILOGUE_F32.name} launch failed: CUDA "
                           f"error {err}")
    ENGINE_EPILOGUE_F32.launches += 1
    return fh_mean


def tree_sum_ref(v: torch.Tensor) -> torch.Tensor:
    """The kernel's fixed-order sum of the 1-D fp32 ``v`` (0-d): ``v[i] +=
    v[i + s]`` for ``s`` halving from the largest power of two below its
    length."""
    v = v.clone()
    n = v.numel()
    s = 1
    while 2 * s < n:
        s *= 2
    while s >= 1:
        m = max(0, min(s, n - s))
        v[:m] = v[:m] + v[s:s + m]
        s //= 2
    return v[0]


def nonfinite_rows(leaves, n: int, device) -> torch.Tensor:
    """Per-slot flag ``[N]``: any non-finite value in any leaf."""
    flags = torch.zeros((n,), dtype=torch.float32, device=device)
    for leaf in leaves:
        bad = torch.any(~torch.isfinite(leaf.reshape(n, -1)), dim=-1)
        flags = torch.maximum(flags, bad.to(torch.float32))
    return flags


def layer_count_totals(counts, n_layers: int) -> list:
    """Per layer the ``[2, N + 1]`` totals of its count rows."""
    from repro_torch.kernels.delta_unit import count_totals
    totals = [None] * n_layers
    for layer, rows in counts:
        t = count_totals(rows)
        totals[layer] = t if totals[layer] is None else totals[layer] + t
    return totals


def engine_epilogue_ref(leaves, counts, cols, carry, x, finite, consts):
    """Plain version: the engine's accounting op by op (``x`` None: keep
    ``last_x``). A layer's firing fraction is its nonzero count times the
    reciprocal of its columns, bitwise the mean of ``delta != 0`` it
    replaces."""
    from repro_torch.core.perf_model import (dram_traffic_bytes_per_timestep,
                                             stack_effective_macs)
    from repro_torch.core.sparsity import recip_mean
    f32 = torch.float32
    n = finite.shape[0]
    dims, rate, w_bits = consts
    poison = 1.0 - finite.to(f32)
    bad = nonfinite_rows(leaves, n, finite.device)
    totals = layer_count_totals(counts, len(cols))
    fx = recip_mean(torch.stack([t[0, :n].to(f32) * (1.0 / cx)
                                 for t, (cx, _) in zip(totals, cols)]), dim=0)
    fh = recip_mean(torch.stack([t[1, :n].to(f32) * (1.0 / ch)
                                 for t, (_, ch) in zip(totals, cols)]), dim=0)

    def latency(gdx, gdh):
        return stack_effective_macs(dims, gdx, gdh) * (1.0 / rate)

    lat = latency(1.0 - fx, 1.0 - fh)
    wb = dram_traffic_bytes_per_timestep(dims, 1.0 - fx, 1.0 - fh,
                                         w_weight_bits=w_bits)
    # tile economics: a column is fetched when ANY stream fired it
    ufx = recip_mean(torch.stack([t[0, n].to(f32) * (1.0 / cx)
                                  for t, (cx, _) in zip(totals, cols)]))
    ufh = recip_mean(torch.stack([t[1, n].to(f32) * (1.0 / ch)
                                  for t, (_, ch) in zip(totals, cols)]))
    tile_lat = latency(1.0 - ufx, 1.0 - ufh)
    tile_wb = dram_traffic_bytes_per_timestep(dims, 1.0 - ufx, 1.0 - ufh,
                                              w_weight_bits=w_bits)
    new = {
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
        # resilience carry (last_x: unless the Delta Unit wrote it)
        "poison_steps": carry["poison_steps"] + poison,
        "bad_state": carry["bad_state"] + bad,
        "agg_poison_steps": carry["agg_poison_steps"] + torch.sum(poison),
        "agg_bad_state": carry["agg_bad_state"] + torch.sum(bad),
    }
    if x is not None:
        new["last_x"] = x
    for k, v in new.items():
        carry[k].copy_(v)
    return recip_mean(fh)
