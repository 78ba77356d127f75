"""The Delta Unit (EdgeDRNN Eq. 2) of one layer step in one launch.

A layer step encodes its input streams against the input threshold and
its hidden streams against the hidden threshold (:func:`repro_torch.core.
delta.delta_encode` on each)::

    raw = s - s_hat;  fired = |raw| >= theta
    delta = raw where fired else 0;  s_hat' = s where fired else s_hat

:func:`delta_unit` does that for every stream of a layer step, and counts
what it passed on for the engine's accounting: for each group (0 = the
input streams, 1 = the hidden streams) and each of the ``N`` stream slots
the nonzero deltas, and the columns that some slot fired (the tile's
union). The counts come as rows ``[N + 2]``: ``N`` per-slot counts, the
union count and the group; the kernel writes one row a block (a tile of
one stream's columns for every slot, :func:`tile_columns`), the plain
version one row a group. A group's counts are the sum of
its rows (:func:`count_totals`).

The JAX package runs Eq. 2 as fused XLA ops inside its jitted step
(``repro/kernels/deltagru_seq.py:13-14``); there is no Pallas kernel
for it. CUDA operands launch ``csrc/delta_unit.cu``; CPU (and meta)
operands run :func:`delta_unit_ref`, the ops the layer steps ran before
the kernel existed. The kernel has no backward: callers that train call
:func:`repro_torch.core.delta.delta_encode` (or its straight-through
twin) directly, as the dense backends do.

``act_grid=(scale, min, max)`` first rounds the input streams onto the
Q8.8 activation grid (half to even, then clipped), the Delta Unit's view
of a ``fused_q8`` / ``fused_q4`` layer's input
(:meth:`repro_torch.kernels.delta_q8.QuantDeltaLayout.quantize_act`).

``guard=FrameGuard(last_x, finite)`` folds the streaming engine's frame
guard into layer 0's launch, whose one input stream is the raw frame:
``finite[n]`` is "every column of slot ``n``'s frame is finite", the frame
becomes ``x`` where finite and ``last_x`` elsewhere (before the rounding
onto the grid), and is written back into ``last_x``; both buffers are
written in place. The engine folds the guard in where :func:`guard_fits`
and guards the frame in plain ops before the step elsewhere.

A :class:`repro_torch.core.delta.StepTheta` threshold of 0 fires every
element of its group, NaN included, as the reference's jitted step does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (DELTA_UNIT_F32, cuda_stream,
                                     launches_kernel, refuse_autograd,
                                     require)

# Constants of csrc/delta_unit.cu.
DU_THREADS = 256       # a block: slot rows x tile columns, a warp a row
DU_MAX_SEGS = 8        # streams (input and hidden together) a launch
DU_MAX_N = 8192        # stream slots a launch (their counts in shared memory)
DU_GUARD_MAX = 256     # columns of a frame the guard takes: one block's tile
DU_UNROLL = 16         # slots a thread has in flight (N > 1): kUnroll


class FrameGuard(NamedTuple):
    """The engine's frame guard on layer 0's launch: ``last_x`` ``[N, I]``
    (read, then overwritten with the guarded frame) and ``finite`` ``[N]``
    bool (written)."""

    last_x: torch.Tensor
    finite: torch.Tensor


class _Seg(ctypes.Structure):
    _fields_ = [("s", ctypes.c_void_p), ("mem", ctypes.c_void_p),
                ("delta", ctypes.c_void_p), ("mem_out", ctypes.c_void_p),
                ("len", ctypes.c_int), ("ld", ctypes.c_int),
                ("group", ctypes.c_int), ("first_block", ctypes.c_int),
                ("tile", ctypes.c_int)]


def tile_columns(n: int, width: int, guarded: bool = False) -> int:
    """Columns a block takes of a ``width``-column segment at ``n`` slots:
    256 over the slot rows a block holds (one a warp, up to 8, the fewest
    that cover ``n``), and at least the whole row of a guarded frame."""
    rows = min(DU_THREADS // 32, 1 << max(n - 1, 0).bit_length())
    tile = DU_THREADS // rows
    if guarded:
        tile = max(tile, 1 << max(width - 1, 31).bit_length())
    return tile


def guard_fits(n: int, width: int) -> bool:
    """Whether layer 0's launch takes the frame guard of ``n`` slots of a
    ``width``-column frame: the frame fits one block's tile (at most
    :data:`DU_GUARD_MAX` columns) and that block holds every slot in one
    turn (its slot rows times :data:`DU_UNROLL` slots). A second turn
    costs the step about what the four plain guard kernels do."""
    if not 0 < width <= DU_GUARD_MAX:
        return False
    rows = DU_THREADS // tile_columns(n, width, True)
    return n <= rows * DU_UNROLL


def count_rows_width(n: int) -> int:
    """Width of a count row for ``n`` stream slots."""
    return n + 2


def count_totals(rows: torch.Tensor) -> torch.Tensor:
    """``[2, N + 1]`` int64: each group's per-slot counts and union count,
    summed over its rows ``[R, N + 2]``."""
    group = rows[:, -1:]
    body = rows[:, :-1].to(torch.int64)
    return torch.stack([(body * (group == g)).sum(0) for g in (0, 1)])


def _theta_arg(theta, dev):
    """A scalar threshold as (device pointer or None, value)."""
    if isinstance(theta, torch.Tensor):
        if theta.numel() != 1:
            raise ValueError("the Delta Unit kernel takes a scalar threshold "
                             f"per group, got shape {tuple(theta.shape)}")
        if theta.device != dev or theta.dtype != torch.float32:
            raise ValueError(f"a tensor threshold must be fp32 on {dev}, got "
                             f"{theta.dtype} on {theta.device}")
        return theta.data_ptr(), 0.0
    return None, float(theta)


def delta_unit(x_streams, h_streams, theta_x, theta_h, *, act_grid=None,
               guard: FrameGuard | None = None):
    """Eq. 2 over a layer step's streams.

    Args:
      x_streams: ``(s, memory)`` pairs of the input group, each ``[N, n]``
        (``s`` may be any row-strided view; ``memory`` the state ``s_hat``).
      h_streams: the same for the hidden group.
      theta_x / theta_h: each group's threshold, a number or a 0-d fp32
        tensor on the operands' device (read there at each launch, so a
        captured graph follows it).
      act_grid: ``(scale, min, max)``: round the input group onto this grid
        first.
      guard: a :class:`FrameGuard`: the one input stream is the raw frame,
        guarded first (``last_x`` and ``finite`` written in place).

    Returns ``(x_out, h_out, counts)``: ``(delta, new_memory)`` pairs in the
    order given, and the int32 count rows ``[R, N + 2]``.
    """
    streams = [*x_streams, *h_streams]
    operands = [t for pair in streams for t in pair]
    if guard is not None:
        if len(x_streams) != 1:
            raise ValueError("the frame guard takes one input stream, the "
                             f"frame; got {len(x_streams)}")
        operands += list(guard)
    if not launches_kernel(*operands):
        return delta_unit_ref(x_streams, h_streams, theta_x, theta_h,
                              act_grid=act_grid, guard=guard)
    refuse_autograd("delta_unit", *operands)
    return _launch(x_streams, h_streams, theta_x, theta_h, act_grid, guard)


def _fn():
    fn = _build.load("delta_unit.cu").delta_unit_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(_Seg), ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                        ctypes.c_float, ctypes.c_int, ctypes.c_float,
                        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x_streams, h_streams, theta_x, theta_h, act_grid, guard):
    from repro_torch.core.delta import fires_all
    f32 = torch.float32
    streams = [(0, s, m) for s, m in x_streams] + [(1, s, m)
                                                   for s, m in h_streams]
    if not 0 < len(streams) <= DU_MAX_SEGS:
        raise ValueError(f"delta_unit takes 1 to {DU_MAX_SEGS} streams, got "
                         f"{len(streams)}")
    n = streams[0][1].shape[0]
    if n > DU_MAX_N:
        raise ValueError(f"delta_unit takes at most {DU_MAX_N} stream slots, "
                         f"got {n}")
    dev = streams[0][1].device
    segs = (_Seg * DU_MAX_SEGS)()
    outs = []
    blocks = 0
    for j, (group, s, mem) in enumerate(streams):
        if s.dim() != 2 or s.shape[0] != n or s.stride(-1) != 1:
            s = s.reshape(n, -1).contiguous()
        width = s.shape[1]
        require(mem.reshape(n, width), f"memory {j}", f32, (n, width),
                align=4)
        if s.dtype != f32:
            raise TypeError(f"stream {j} must be fp32, got {s.dtype}")
        mem = mem.reshape(n, width)
        delta = torch.empty((n, width), dtype=f32, device=dev)
        mem_out = torch.empty((n, width), dtype=f32, device=dev)
        tile = tile_columns(n, width, guard is not None and j == 0)
        segs[j] = _Seg(s.data_ptr(), mem.data_ptr(), delta.data_ptr(),
                       mem_out.data_ptr(), width, s.stride(0), group,
                       blocks, tile)
        blocks += -(-width // tile)
        outs.append((delta, mem_out))
    last_x = finite = None
    if guard is not None:
        width = segs[0].len
        if not 0 < width <= DU_GUARD_MAX:
            raise ValueError(f"the frame guard takes a frame of 1 to "
                             f"{DU_GUARD_MAX} columns, got {width}")
        last_x = require(guard.last_x, "last_x", f32, (n, width),
                         align=4).data_ptr()
        finite = require(guard.finite, "finite", torch.bool, (n,),
                         align=1).data_ptr()
    counts = (torch.empty if blocks else torch.zeros)(
        (max(blocks, 1), count_rows_width(n)), dtype=torch.int32, device=dev)
    tx_ptr, tx = _theta_arg(theta_x, dev)
    th_ptr, th = _theta_arg(theta_h, dev)
    fire_all = int(fires_all(theta_x)) | 2 * int(fires_all(theta_h))
    scale, lo, hi = act_grid if act_grid is not None else (0.0, 0.0, 0.0)
    err = _fn()(segs, len(streams), n, tx_ptr, tx, th_ptr, th, fire_all,
                scale, lo, hi, last_x, finite, counts.data_ptr(), blocks,
                cuda_stream(counts))
    if err:
        raise RuntimeError(f"{DELTA_UNIT_F32.name} launch failed: CUDA error "
                           f"{err}")
    DELTA_UNIT_F32.launches += 1
    k = len(x_streams)
    return outs[:k], outs[k:], counts


def count_rows_ref(x_deltas, h_deltas) -> torch.Tensor:
    """The count rows ``[2, N + 2]`` (int32) of one layer step's deltas,
    one row a group: the input group's deltas ``x_deltas`` and the hidden
    group's ``h_deltas``, each ``[N, ...]``. Built without indexed writes,
    so it never synchronises a CUDA device."""
    d0 = next(iter((*x_deltas, *h_deltas)))
    n, dev = d0.shape[0], d0.device
    rows = []
    for g, deltas in enumerate((x_deltas, h_deltas)):
        per = torch.zeros((n,), dtype=torch.int64, device=dev)
        union = torch.zeros((1,), dtype=torch.int64, device=dev)
        for d in deltas:
            nz = (d != 0).reshape(n, -1)
            per = per + nz.sum(-1)
            union = union + nz.any(0).sum()
        rows.append(torch.cat([per, union, torch.full(
            (1,), g, dtype=torch.int64, device=dev)]))
    return torch.stack(rows).to(torch.int32)


def guard_frame_ref(x: torch.Tensor, guard: FrameGuard) -> torch.Tensor:
    """The frame guard op by op: ``finite`` (every column finite: ``x - x``
    is 0 exactly there) and the guarded frame, both written into the
    guard's buffers; returns the guarded frame."""
    finite = torch.all(x - x == 0, dim=-1)
    x = torch.where(finite[:, None], x, guard.last_x)
    guard.finite.copy_(finite)
    guard.last_x.copy_(x)
    return x


def delta_unit_ref(x_streams, h_streams, theta_x, theta_h, *, act_grid=None,
                   guard: FrameGuard | None = None):
    """Plain version: the frame guard on the input stream when given
    (:func:`guard_frame_ref`), then :func:`repro_torch.core.delta.
    delta_encode` on each stream (the input group first rounded onto
    ``act_grid``), and one count row a group (:func:`count_rows_ref`)."""
    from repro_torch.core.delta import DeltaState, delta_encode
    from repro_torch.kernels.delta_q8 import _grid_round
    if guard is not None:
        (s, mem), = x_streams
        x_streams = [(guard_frame_ref(s, guard), mem)]
    groups = []
    for g, (streams, theta) in enumerate(((x_streams, theta_x),
                                          (h_streams, theta_h))):
        outs = []
        for s, mem in streams:
            if g == 0 and act_grid is not None:
                s = _grid_round(s, *act_grid)
            enc = delta_encode(s, DeltaState(mem), theta)
            outs.append((enc.delta, enc.state.memory))
        groups.append(outs)
    counts = count_rows_ref([d for d, _ in groups[0]],
                            [d for d, _ in groups[1]])
    return groups[0], groups[1], counts
