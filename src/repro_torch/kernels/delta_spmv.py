"""Block-column-skipping delta matvec (the paper's sparse MxV), the PyTorch
port of :mod:`repro.kernels.delta_spmv`.

EdgeDRNN skips single weight columns per zero delta element; the kernel
skips ``block_k``-wide column blocks: a block in which no stream of ``dx``
fired is never read, so the weight traffic is ``(1 - Gamma_block) *
bytes(W)`` (Eq. 8 at block granularity).

Weight layout: ``w: [O, I]`` (output-major). Callers that own the weights
pack them once with :func:`pack_spmv_weights` and pass ``packed=True`` with
the true ``out_dim``; an unpacked ``w`` (any ``I``) is taken as it is, and
the kernel masks its ragged edge itself.

:func:`delta_spmv` launches the CUDA kernel of ``csrc/delta_spmv.cu`` for
CUDA tensors and runs the plain version :func:`delta_spmv_ref` for CPU
tensors. fp32 only: the accumulator is fp32 as in the JAX kernel, and a
bf16 weight stream is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (DELTA_SPMV_F32, cuda_stream,
                                     launches_kernel, require)


def pack_spmv_weights(w: torch.Tensor, block_o: int = 128,
                      block_k: int = 128) -> torch.Tensor:
    """Zero-pad ``w: [O, I]`` to block multiples once, at pack time."""
    o_dim, i_dim = w.shape
    return torch.nn.functional.pad(
        w, (0, (-i_dim) % block_k, 0, (-o_dim) % block_o)).contiguous()


def delta_spmv(w: torch.Tensor, dx: torch.Tensor,
               acc: torch.Tensor | None = None, *, block_k: int = 128,
               packed: bool = False,
               out_dim: int | None = None) -> torch.Tensor:
    """``acc + dx @ w.T`` reading only the fired column blocks of ``w``.

    Args:
      w: ``[O, I]`` weights, or the :func:`pack_spmv_weights` layout when
        ``packed=True``.
      dx: ``[B, I]`` delta vectors (zeros = not fired).
      acc: ``[B, O]`` accumulator (delta memory M); zeros if None.
      block_k: width of a skipped column block.
      packed: ``w`` is block-padded (its k extent is ``I`` rounded up to
        ``block_k``).
      out_dim: the true output dim O when ``packed`` (default
        ``w.shape[0]``).

    Returns ``[B, O]`` fp32. CUDA operands launch the kernel; CPU operands
    run :func:`delta_spmv_ref`.
    """
    operands = [t for t in (w, dx, acc) if t is not None]
    for t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"delta_spmv takes fp32 operands only, got "
                            f"{t.dtype}; a bf16 delta_spmv is not ported")
    b, i_dim = dx.shape
    o_dim = out_dim if (packed and out_dim is not None) else w.shape[0]
    if packed:
        kp = i_dim + (-i_dim) % block_k
        if w.shape[1] != kp or o_dim > w.shape[0]:
            raise ValueError(
                f"packed weights {tuple(w.shape)} do not hold [{o_dim}, "
                f"{i_dim}] padded to block_k={block_k}; pack with "
                "pack_spmv_weights and the same block_k")
    elif w.shape[1] != i_dim:
        raise ValueError(f"w {tuple(w.shape)} and dx {tuple(dx.shape)} "
                         "disagree on I")
    if not launches_kernel(*operands):
        return delta_spmv_ref(w[:o_dim, :i_dim], dx, acc)
    return _launch(w, dx, acc, o_dim, block_k)


def _fn():
    fn = _build.load("delta_spmv.cu").delta_spmv_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(w, dx, acc, o_dim: int, block_k: int) -> torch.Tensor:
    b, i_dim = dx.shape
    f32 = torch.float32
    require(w, "w", f32, tuple(w.shape))
    require(dx, "dx", f32, (b, i_dim))
    if acc is not None:
        require(acc, "acc", f32, (b, o_dim))
    out = torch.empty((b, o_dim), dtype=f32, device=dx.device)
    err = _fn()(w.data_ptr(), dx.data_ptr(),
                acc.data_ptr() if acc is not None else None, out.data_ptr(),
                b, i_dim, o_dim, w.shape[1], block_k, cuda_stream(dx))
    if err:
        raise RuntimeError(f"delta_spmv_f32 launch failed: CUDA error {err}")
    DELTA_SPMV_F32.launches += 1
    return out


def delta_spmv_ref(w: torch.Tensor, dx: torch.Tensor,
                   acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version (the port of the JAX oracle ``delta_spmv_ref``):
    ``w: [O, I]``, ``dx: [B, I]``, ``acc: [B, O]``. Blocks that no stream
    fired contribute exact zeros either way, so the dense product is the
    block-skipped one. On a CUDA device TF32 must be off for matmuls
    (PyTorch's default)."""
    out = dx @ w.T
    return out if acc is None else acc + out


def delta_spmv_hbm_bytes(w_shape, dx: torch.Tensor, block_k: int = 128,
                         weight_bytes: int = 2) -> torch.Tensor:
    """Model of the weight traffic of one call: fired column blocks times
    ``block_k`` columns times ``O`` rows (for the roofline and benches)."""
    o_dim, i_dim = w_shape
    b = dx.shape[0]
    dxp = torch.nn.functional.pad(dx, (0, (-i_dim) % block_k))
    fired = torch.any((dxp.reshape(b, -1, block_k) != 0), dim=2).any(dim=0)
    return torch.sum(fired) * block_k * o_dim * weight_bytes
