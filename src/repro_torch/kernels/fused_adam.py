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
first chunk) is written to device memory before the launch: by a pinned
copy on the stream in an eager call, and once after the capture in a CUDA
graph (:func:`repro_torch.kernels.ops.table_after_capture`), whose
replays then read the table written once after the capture.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (FUSED_ADAM_BF16, FUSED_ADAM_F32,
                                     H100_SMS, cuda_stream, launches_kernel,
                                     table_after_capture)

# Constants of csrc/fused_adam.cu.
FA_THREADS = 256
FA_CHUNK = 8192          # elements of a leaf a block takes at a time
FA_BLOCKS_PER_SM = 8     # 2048 threads an SM
# a leaf's row: p, g, mu, nu, p_out, mu_out, nu_out, n, item0, g_bf16
TABLE_WORDS = 10

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


def leaf_table(rows) -> tuple:
    """The kernel's leaf table of one launch. ``rows``: per leaf ``(ptrs,
    n, g_bf16)`` with ``ptrs`` the seven addresses (p, g, mu, nu, p_out,
    mu_out, nu_out). Empty leaves are left out. Returns ``(table, items)``:
    an int64 ``[leaves, TABLE_WORDS]`` array and the chunks of
    ``FA_CHUNK`` elements over all leaves (``item0`` numbers each leaf's
    first)."""
    table, items = [], 0
    for ptrs, n, g_bf16 in rows:
        if n == 0:
            continue
        table.append([*ptrs, n, items, int(g_bf16)])
        items += -(-n // FA_CHUNK)
    return np.array(table, dtype=np.int64).reshape(-1, TABLE_WORDS), items


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
        table, items = leaf_table(rows)
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


def _device_table(table: np.ndarray, device) -> torch.Tensor:
    """The table in device memory: written after the capture when one is
    running (the graph keeps the address), else by a pinned copy now."""
    host = torch.from_numpy(table)
    if torch.cuda.is_current_stream_capturing():
        return table_after_capture(host)
    return host.pin_memory().to(device, non_blocking=True)


def _launch(kinfo, table, items, scale, lr, corr1, corr2, consts, decay):
    dev_table = _device_table(table, lr.device)
    grid = max(1, min(items, H100_SMS * FA_BLOCKS_PER_SM))
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
