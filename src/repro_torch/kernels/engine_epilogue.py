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
existed, in the same order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (ENGINE_EPILOGUE_F32, cuda_stream,
                                     launches_kernel, require)

# Constants of csrc/engine_epilogue.cu.
EP_MAX_LEAVES = 1024     # state leaves a launch scans
EP_MAX_COUNTS = 256      # count tensors a launch reads
EP_MAX_LAYERS = 128      # layers
EP_MAX_N = 1024          # stream slots
EP_CHUNK = 4096          # elements of a leaf row a block scans at a time
EP_THREADS = 256
EP_GRID = 528            # blocks at most: 4 an SM of an H100

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


def engine_epilogue(leaves, counts, cols, carry: dict, x: torch.Tensor,
                    finite: torch.Tensor, consts: EpilogueConsts,
                    workspace: torch.Tensor | None = None) -> torch.Tensor:
    """Account for one engine step and update ``carry`` in place.

    Args:
      leaves: every tensor of the new state, each ``[N, ...]``.
      counts: ``(layer, count rows)`` pairs in layer order, the rows of
        the Delta Unit launches of each layer (one or more a layer).
      cols: per layer ``(input columns, hidden columns)``.
      carry: the engine's carry (every key but ``theta_h`` is written).
      x: the guarded frame ``[N, I]`` (becomes ``last_x``).
      finite: ``[N]`` bool, the frame guard's verdict (``poison = 1 -
        finite``).
      consts: :class:`EpilogueConsts`.
      workspace: CUDA only: int32 ``[N + 1]`` of zeros, left zero by the
        launch (allocated zeroed for the call when None).

    Returns the 0-d mean over the slots of the hidden firing fraction.
    """
    operands = [x, finite, *leaves, *(c for _, c in counts),
                *carry.values()]
    if not launches_kernel(*operands):
        return engine_epilogue_ref(leaves, counts, cols, carry, x, finite,
                                   consts)
    return _launch(leaves, counts, cols, carry, x, finite, consts,
                   workspace)


def _fn():
    fn = _build.load("engine_epilogue.cu").engine_epilogue_f32
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci, ci, ci,
                       ci, vp, vp, vp,
                       ci, vp, vp, vp,
                       vp, cf, cf, cf, cf, cf, cf,
                       vp, ci, vp]
        fn.restype = ctypes.c_int
    return fn


def _arr(ctype, values):
    return (ctype * max(len(values), 1))(*values)


def _launch(leaves, counts, cols, carry, x, finite, consts, workspace):
    f32 = torch.float32
    n, i_dim = x.shape
    n_layers = len(cols)
    if n > EP_MAX_N or len(leaves) > EP_MAX_LEAVES \
            or len(counts) > EP_MAX_COUNTS or not 0 < n_layers <= EP_MAX_LAYERS:
        raise ValueError(
            f"engine_epilogue takes at most {EP_MAX_N} slots, "
            f"{EP_MAX_LEAVES} leaves, {EP_MAX_COUNTS} count tensors and "
            f"{EP_MAX_LAYERS} layers; got {n}, {len(leaves)}, "
            f"{len(counts)}, {n_layers}")
    require(x, "x", f32, (n, i_dim), align=4)
    require(finite, "finite", torch.bool, (n,), align=1)
    ptrs, rows, lds, item0 = [], [], [], [0]
    keep = []
    for j, leaf in enumerate(leaves):
        if leaf.dtype != f32 or leaf.dim() < 1 or leaf.shape[0] != n:
            raise ValueError(f"state leaf {j}: want fp32 [{n}, ...], got "
                             f"{leaf.dtype} {tuple(leaf.shape)}")
        row = leaf.numel() // n if n else 0
        v = leaf.reshape(n, row)          # a view wherever the rows allow
        if row > 1 and v.stride(1) != 1:
            v = v.contiguous()
        keep.append(v)
        ptrs.append(v.data_ptr())
        rows.append(row)
        lds.append(v.stride(0) if row else 0)
        item0.append(item0[-1] + n * -(-row // EP_CHUNK))
    c_ptrs, c_rows, c_first = [], [], [0] * (n_layers + 1)
    for layer, c in sorted(counts, key=lambda lc: lc[0]):
        require(c, f"counts of layer {layer}", torch.int32,
                (c.shape[0], n + 2), align=4)
        c_ptrs.append(c.data_ptr())
        c_rows.append(c.shape[0])
        c_first[layer + 1] += 1
    for layer in range(n_layers):
        c_first[layer + 1] += c_first[layer]
    inv_cols = [1.0 / w if w else 0.0 for pair in cols for w in pair]
    io = [x, finite, carry["last_x"]]
    io += [carry[k] for k in PER_STREAM] + [carry[k] for k in AGGREGATES]
    for k in PER_STREAM:
        require(carry[k], k, f32, (n,), align=4)
    for k in AGGREGATES:
        require(carry[k], k, f32, (), align=4)
    require(carry["last_x"], "last_x", f32, (n, i_dim), align=4)
    fh_mean = torch.empty((), dtype=f32, device=x.device)
    if workspace is None:
        workspace = torch.zeros((n + 1,), dtype=torch.int32, device=x.device)
    require(workspace, "workspace", torch.int32, (n + 1,), align=4)
    frac = torch.empty((n_layers * 2 * (n + 1),), dtype=f32, device=x.device)
    io += [fh_mean, workspace, frac]
    items = item0[-1]
    grid = max(1, min(EP_GRID, max(items, -(-n * i_dim // EP_THREADS))))
    dims = consts.dims
    err = _fn()(
        n, i_dim, n_layers,
        len(leaves), _arr(ctypes.c_uint64, ptrs), _arr(ctypes.c_int, rows),
        _arr(ctypes.c_int, lds),
        len(c_ptrs), _arr(ctypes.c_uint64, c_ptrs), _arr(ctypes.c_int, c_rows),
        _arr(ctypes.c_int, c_first),
        _arr(ctypes.c_float, inv_cols), 1.0 / n_layers, 1.0 / n,
        float(dims.x_weight_volume), float(dims.h_weight_volume),
        1.0 / consts.rate, float(consts.w_bits),
        _arr(ctypes.c_uint64, [t.data_ptr() for t in io]), grid,
        cuda_stream(x))
    if err:
        raise RuntimeError(f"{ENGINE_EPILOGUE_F32.name} launch failed: CUDA "
                           f"error {err}")
    ENGINE_EPILOGUE_F32.launches += 1
    del keep
    return fh_mean


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
    """Plain version: the engine's accounting op by op. A layer's firing
    fraction is its nonzero count times the reciprocal of its columns,
    bitwise the mean of ``delta != 0`` it replaces."""
    from repro_torch.core.perf_model import (dram_traffic_bytes_per_timestep,
                                             stack_effective_macs)
    from repro_torch.core.sparsity import recip_mean
    f32 = torch.float32
    n = x.shape[0]
    dims, rate, w_bits = consts
    poison = 1.0 - finite.to(f32)
    bad = nonfinite_rows(leaves, n, x.device)
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
        # resilience carry
        "last_x": x,
        "poison_steps": carry["poison_steps"] + poison,
        "bad_state": carry["bad_state"] + bad,
        "agg_poison_steps": carry["agg_poison_steps"] + torch.sum(poison),
        "agg_bad_state": carry["agg_bad_state"] + torch.sum(bad),
    }
    for k, v in new.items():
        carry[k].copy_(v)
    return recip_mean(fh)
