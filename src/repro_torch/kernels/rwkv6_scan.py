"""WKV6 recurrence (RWKV-6 "Finch"), the PyTorch port of
:mod:`repro.kernels.rwkv6_scan`.

Per (stream, head) the state ``S: [D, D]`` (key-dim x value-dim, D = 64)
evolves with a data-dependent per-key decay ``w_t`` in (0, 1) and a bonus
``u`` on the current token::

    y_t = r_t (S + diag(u) k_t^T v_t)
    S  <- diag(w_t) S + k_t^T v_t

:func:`rwkv6_scan` launches the CUDA kernel of ``csrc/rwkv6_scan.cu`` for
CUDA tensors and runs the plain version :func:`rwkv6_scan_batched_ref` for
CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (RWKV6_SCAN_F32, cuda_stream,
                                     launches_kernel, require)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None):
    """WKV6 over ``r, k, v, w: [B, H, T, D]`` with bonus ``u: [H, D]`` and
    initial state ``s0: [B, H, D, D]`` (zeros if None); ``w`` is the decay
    factor in (0, 1). Returns ``(y: [B, H, T, D], s_T: [B, H, D, D])``."""
    operands = [t for t in (r, k, v, w, u, s0) if t is not None]
    if not launches_kernel(*operands):
        return rwkv6_scan_batched_ref(r, k, v, w, u, s0)
    return _launch(r, k, v, w, u, s0)


def _fn():
    fn = _build.load("rwkv6_scan.cu").rwkv6_scan_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(r, k, v, w, u, s0):
    b, h, t, d = r.shape
    f32 = torch.float32
    r, k, v, w = (z.contiguous() for z in (r, k, v, w))
    for z, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        require(z, name, f32, (b, h, t, d))
    require(u, "u", f32, (h, d))
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=f32, device=r.device)
    require(s0, "s0", f32, (b, h, d, d))
    y = torch.empty_like(r)
    s_t = torch.empty_like(s0)
    err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_t.data_ptr(),
                b, h, t, d, cuda_stream(r))
    if err:
        raise RuntimeError(f"rwkv6_scan_f32 launch failed: CUDA error {err}")
    RWKV6_SCAN_F32.launches += 1
    return y, s_t


def rwkv6_scan_batched_ref(r, k, v, w, u, s0=None):
    """Plain version over ``r, k, v, w: [B, H, T, D]``, ``u: [H, D]`` (the
    port of the JAX oracle ``rwkv6_scan_batched_ref``): a loop over T of the
    per-step update, all streams and heads at once."""
    b, h, t, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=r.dtype, device=r.device)
         if s0 is None else s0)
    ys = []
    for i in range(t):
        r_t, k_t, v_t, w_t = r[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i]
        kv = k_t[..., :, None] * v_t[..., None, :]               # [B,H,D,D]
        y = (r_t[..., None, :] @ (s + u[:, :, None] * kv))[..., 0, :]
        s = w_t[..., :, None] * s + kv
        ys.append(y)
    return torch.stack(ys, dim=2), s


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """Single-head plain version: ``r, k, v, w: [T, D]``, ``u: [D]``,
    ``s0: [D, D]``. Returns ``(y: [T, D], S_T)``."""
    y, s = rwkv6_scan_batched_ref(
        r[None, None], k[None, None], v[None, None], w[None, None], u[None],
        None if s0 is None else s0[None, None])
    return y[0, 0], s[0, 0]
