"""The AdamW update of a parameter tree in one launch.

:func:`repro_torch.train.optim.adam_update` computes the clip scale (the
global norm), the learning rate and the bias corrections in plain ops, as
0-d tensors on the parameters' device, then hands the leaves to
:func:`fused_adam`. The JAX package runs the same update as an XLA fusion
inside its jitted train steps; there is no Pallas kernel to port.

CUDA operands launch ``csrc/fused_adam.cu``, one launch a parameter dtype
present (``fused_adam_f32``, ``fused_adam_bf16``); CPU (and meta) operands
run :func:`fused_adam_ref`, the per-leaf ops ``adam_update`` ran before the
kernel existed, in the same order. The kernel rounds every operation on
its own, so on the card the two agree bitwise.

The leaves' table (pointers, lengths, the gradient's dtype, each leaf's
first chunk and its plan: a scalar head, whole pieces of ``FA_PIECE``
elements that take vector accesses, a scalar tail; :func:`leaf_plan`) is
written to device memory before the launch: by a pinned copy on the
stream in an eager call, and once after the capture in a CUDA graph
(:func:`repro_torch.kernels.ops.device_table`), whose replays then read
the table written once after the capture.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (FUSED_ADAM_BF16, FUSED_ADAM_F32,
                                     H100_SMS, cuda_stream, device_table,
                                     launches_kernel)

# Constants of csrc/fused_adam.cu.
FA_THREADS = 256
FA_WARPS = FA_THREADS // 32
FA_CHUNK = 8192          # elements of a leaf a chunk
FA_TILE = 256            # elements a warp's tile
FA_PIECE = 4             # elements a lane's access (16 bytes of fp32)
FA_ALIGN = 16            # bytes every operand starts on after the head
FA_HEAD_MAX = 8          # elements a head search tries
FA_BLOCKS_PER_SM = 2     # the kernel's launch bounds
# a leaf's row: p, g, mu, nu, p_out, mu_out, nu_out, n, item0, g_bf16,
# head, vec
TABLE_WORDS = 12

_INSTANCES = {torch.float32: FUSED_ADAM_F32, torch.bfloat16: FUSED_ADAM_BF16}
_GRAD_DTYPES = (torch.float32, torch.bfloat16)


def host_constants(b1: float, b2: float, eps: float,
                   weight_decay: float) -> tuple:
    """``(b1, 1 - b1, b2, 1 - b2, eps, wd)`` as the float32 values PyTorch
    multiplies by: each difference taken in double, then rounded to float32
    once, as a Python scalar operand of a float32 op is. ``1 - 0.9`` gives
    0.1f; ``1.0f - 0.9f`` would give 0.100000024."""
    return tuple(float(np.float32(v)) for v in
                 (b1, 1 - b1, b2, 1 - b2, eps, weight_decay))


def leaf_plan(n: int, ptrs, sizes) -> tuple:
    """How the kernel cuts a leaf of ``n`` elements whose operands start at
    the addresses ``ptrs`` with elements of ``sizes`` bytes: ``(head,
    body, tail, vec)``, a scalar head, a body of whole ``FA_PIECE``-element
    pieces that take vector accesses, a scalar tail (``head + body + tail
    == n``, ``tail < FA_PIECE``). With ``vec`` the head is the first
    element at which every operand starts on ``FA_ALIGN`` bytes; a leaf
    with no such element among the first ``FA_HEAD_MAX`` (operands at odd
    phases) is all tail, taken element by element."""
    for h in range(FA_HEAD_MAX):
        if all((ptr + h * size) % FA_ALIGN == 0
               for ptr, size in zip(ptrs, sizes)):
            head = min(h, n)
            body = (n - head) // FA_PIECE * FA_PIECE
            return head, body, n - head - body, True
    return 0, 0, n, False


def leaf_table(rows, p_bf16: bool = False) -> tuple:
    """The kernel's leaf table of one launch. ``rows``: per leaf ``(ptrs,
    n, g_bf16)`` with ``ptrs`` the seven addresses (p, g, mu, nu, p_out,
    mu_out, nu_out); ``p_bf16``: the instance's parameter dtype. Empty
    leaves are left out. Returns ``(table, items)``: an int64 ``[leaves,
    TABLE_WORDS]`` array and the chunks of ``FA_CHUNK`` elements over all
    leaves (``item0`` numbers each leaf's first; a chunk holds
    ``FA_CHUNK / FA_TILE`` tile slots, :func:`tile_elements`)."""
    table, items = [], 0
    p_size = 2 if p_bf16 else 4
    for ptrs, n, g_bf16 in rows:
        if n == 0:
            continue
        sizes = (p_size, 2 if g_bf16 else 4, 4, 4, p_size, 4, 4)
        head, _, _, vec = leaf_plan(n, ptrs, sizes)
        table.append([*ptrs, n, items, int(g_bf16), head, int(vec)])
        items += -(-n // FA_CHUNK)
    return np.array(table, dtype=np.int64).reshape(-1, TABLE_WORDS), items


def leaf_tiles(n: int, head: int) -> int:
    """Tiles of ``FA_TILE`` elements the kernel gives a leaf after its
    head: at least one, which also takes the head."""
    return max(1, -(-(n - head) // FA_TILE))


def tile_elements(n: int, head: int, r: int) -> list:
    """The elements of a leaf's tile ``r`` as the kernel's warp takes them,
    lane by lane: a lane's pieces of ``FA_PIECE`` elements (at ``head + r
    * FA_TILE + FA_PIECE * lane`` and every ``32 * FA_PIECE`` after, up to
    the tile's end) up to the leaf's end, then, in tile 0, the head."""
    base = head + r * FA_TILE
    out = []
    for lane in range(32):
        for q in range(0, FA_TILE, 32 * FA_PIECE):
            i = base + q + FA_PIECE * lane
            out.extend(range(i, min(i + FA_PIECE, n)))
    if r == 0:
        out.extend(range(head))
    return out


def warp_slots(slots: int, grid: int) -> list:
    """Each warp's tile slots in the order it takes them, block by block
    and warp by warp: one sweep of the grid over the launch's slots
    (``FA_CHUNK / FA_TILE`` a chunk) in tree order, warp w of block b
    taking slot ``b * FA_WARPS + w`` and then every ``grid * FA_WARPS``."""
    stride = grid * FA_WARPS
    return [list(range(b * FA_WARPS + w, slots, stride))
            for b in range(grid) for w in range(FA_WARPS)]


def adam_grid(items: int) -> int:
    """Blocks of a launch over ``items`` chunks: every resident block the
    card holds, or one a chunk."""
    return max(1, min(items, H100_SMS * FA_BLOCKS_PER_SM))


def launch_groups(params, grads, mu, nu, out) -> dict:
    """The leaves grouped by parameter dtype, in tree order: ``{dtype:
    [(ptrs, n, g_bf16), ...]}``, each leaf checked against what the kernel
    takes (fp32 or bf16 parameters; fp32 or bf16 gradients; fp32 moments;
    every operand contiguous and of the parameter's shape; each output of
    its input's dtype)."""
    p_out, mu_out, nu_out = out
    groups = {}
    for j, ts in enumerate(zip(params, grads, mu, nu, p_out, mu_out, nu_out)):
        p, g = ts[0], ts[1]
        if p.dtype not in _INSTANCES or g.dtype not in _GRAD_DTYPES:
            raise TypeError(f"fused_adam leaf {j}: parameters and gradients "
                            f"must be fp32 or bf16, got {p.dtype} and "
                            f"{g.dtype}")
        want = (p.dtype, g.dtype, torch.float32, torch.float32, p.dtype,
                torch.float32, torch.float32)
        for t, dt, name in zip(ts, want, ("p", "g", "mu", "nu", "p_out",
                                          "mu_out", "nu_out")):
            if t.dtype != dt or t.shape != p.shape or not t.is_contiguous():
                raise ValueError(
                    f"fused_adam leaf {j}: {name} must be a contiguous {dt} "
                    f"tensor of shape {tuple(p.shape)}, got {t.dtype} "
                    f"{tuple(t.shape)} (contiguous: {t.is_contiguous()})")
        groups.setdefault(p.dtype, []).append(
            (tuple(t.data_ptr() for t in ts), p.numel(),
             g.dtype == torch.bfloat16))
    return groups


def fused_adam(params, grads, mu, nu, *, scale, lr, corr1, corr2, b1, b2,
               eps, weight_decay, out=None):
    """One AdamW step of every leaf.

    Args:
      params, grads, mu, nu: lists of leaves (the moments fp32).
      scale: the 0-d fp32 clip scale, or None without clipping.
      lr, corr1, corr2: 0-d fp32 tensors, the step's learning rate and
        ``1 - b1 ** t``, ``1 - b2 ** t``.
      b1, b2, eps, weight_decay: the optimizer's floats (no decay at 0).
      out: ``(params', mu', nu')`` lists to write, which may be ``params``,
        ``mu`` and ``nu`` themselves (an update in place); new tensors when
        None.

    Returns ``(params', mu', nu')``.
    """
    scalars = [lr, corr1, corr2] + ([scale] if scale is not None else [])
    if not launches_kernel(*params, *grads, *mu, *nu, *scalars):
        return fused_adam_ref(params, grads, mu, nu, scale=scale, lr=lr,
                              corr1=corr1, corr2=corr2, b1=b1, b2=b2,
                              eps=eps, weight_decay=weight_decay, out=out)
    if out is None:
        out = ([torch.empty_like(p) for p in params],
               [torch.empty_like(m) for m in mu],
               [torch.empty_like(v) for v in nu])
    for t, name in zip(scalars, ("lr", "corr1", "corr2", "scale")):
        if t.dtype != torch.float32 or t.dim() != 0:
            raise ValueError(f"fused_adam: {name} must be a 0-d fp32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    groups = launch_groups(params, grads, mu, nu, out)
    consts = host_constants(b1, b2, eps, weight_decay)
    for dtype, rows in groups.items():
        table, items = leaf_table(rows, dtype == torch.bfloat16)
        if items:
            _launch(_INSTANCES[dtype], table, items, scale, lr, corr1, corr2,
                    consts, bool(weight_decay))
    return out


def _fn():
    fn = _build.load("fused_adam.cu").fused_adam
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ci, vp, ci, ctypes.c_longlong, vp, vp, vp, vp,
                       cf, cf, cf, cf, cf, cf, ci, ci, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(kinfo, table, items, scale, lr, corr1, corr2, consts, decay):
    dev_table = device_table(table, lr.device)
    grid = adam_grid(items)
    err = _fn()(
        int(kinfo is FUSED_ADAM_BF16), dev_table.data_ptr(), len(table),
        items, None if scale is None else scale.data_ptr(), lr.data_ptr(),
        corr1.data_ptr(), corr2.data_ptr(), *consts, int(decay), grid,
        cuda_stream(lr))
    if err:
        raise RuntimeError(f"{kinfo.name} launch failed: CUDA error {err}")
    kinfo.launches += 1


def fused_adam_ref(params, grads, mu, nu, *, scale, lr, corr1, corr2, b1,
                   b2, eps, weight_decay, out=None):
    """Plain version: the AdamW update leaf by leaf, op by op, as
    ``adam_update`` computed it before the kernel (the JAX package's order):
    the clip scale applied (a bf16 gradient promoted to fp32 first, as JAX
    promotes it), then the moments, the bias-corrected step, the decay and
    the parameter rounded to its dtype. With ``out`` the results are copied
    into those tensors."""
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        if scale is not None:
            g = g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / corr1) / (torch.sqrt(v / corr2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_mu.append(m)
        new_nu.append(v)
    if out is None:
        return new_p, new_mu, new_nu
    for dst, src in zip((*out[0], *out[1], *out[2]),
                        (*new_p, *new_mu, *new_nu)):
        dst.copy_(src)
    return out
