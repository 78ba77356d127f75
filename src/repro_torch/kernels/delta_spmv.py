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

Operands are fp32 or bf16, in any mix: the products and sums run in fp32
(the JAX kernel's ``preferred_element_type``), and the result takes
``acc``'s type, or ``w``'s when ``acc`` is None.

:func:`delta_spmv` launches the CUDA kernel of ``csrc/delta_spmv.cu`` for
CUDA tensors and runs the plain version :func:`delta_spmv_ref` for CPU
tensors. :func:`spmv_launch_plan` is its launch plan (instance, streams a
pass, the k split of narrow outputs, shared memory), computed on the host
once per shape, ``B``, weight type and device and cached, so a launch makes
no CUDA API query.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.delta_q8 import SMEM_OPTIN_BYTES, _kpad
from repro_torch.kernels.ops import (DELTA_SPMV_BF16, DELTA_SPMV_F32,
                                     H100_SMS, cuda_stream, launches_kernel,
                                     require)

SPMV_DTYPES = (torch.float32, torch.bfloat16)
# Constants of csrc/delta_spmv.cu the plan mirrors.
SPMV_ROWS = 8            # output rows (warps) a block: kRows
SPMV_MAX_STREAMS = 8     # streams a pass of the tile instance: kMaxB
SPMV_UNROLL = 8          # 16-byte loads a lane has in flight: kUnroll
SPMV_MAX_SPLIT = 8       # blocks a cluster: kMaxSplit (the portable limit)
SPMV_MAX_ROWS = 2        # rows a warp walks at once: kMaxRowsPerWarp
SPMV_INSTANCES = ("one_stream", "tile", "narrow")   # their codes: the index
# The plan splits the k blocks of an output with fewer row groups than the
# H100's SMs (ops.H100_SMS), and gives the one-stream instance no more
# blocks than the SMs hold at once (SPMV_BLOCKS_PER_SM an SM at its
# registers), so no block waits for a second wave.
SPMV_BLOCKS_PER_SM = 2


@dataclass(frozen=True)
class SpmvLaunchPlan:
    """How one ``delta_spmv`` call launches (:func:`spmv_launch_plan`).

    ``instance``: ``"one_stream"`` (B = 1, one accumulator a lane),
    ``"tile"`` (up to ``SPMV_MAX_STREAMS`` streams a pass) or ``"narrow"``
    (a row stride or ``block_k`` that is not a whole number of 16-byte
    vectors: one element a lane, any B). ``chunk``: streams a pass.
    ``split``: blocks of a cluster that share one row group's k blocks (1:
    no split). ``grid``: blocks of ``SPMV_ROWS`` warps; ``rows``: rows a
    warp walks at once (1 or 2; the warps of the grid take the rows in
    turn). ``smem``: dynamic shared memory in bytes. ``vector_elems``:
    weights a lane loads at once. ``blocks_per_group``: the fired
    ``block_k`` blocks one unrolled group of the walk covers
    (``SPMV_UNROLL`` steps of 32 vectors, over ``rows`` rows).
    ``device``: the CUDA device index (-1 for none)."""

    instance: str
    chunk: int
    split: int
    smem: int
    grid: int
    rows: int
    vector_elems: int
    blocks_per_group: int
    device: int


def spmv_smem_bytes(kp: int, block_k: int, chunk: int, split: int) -> int:
    """Dynamic shared memory of one launch, laid out as ``smem_bytes`` of
    ``csrc/delta_spmv.cu``: the staged deltas, the vote words, each warp's
    fired-block list and, split, each warp's partial sums."""
    return (4 * chunk * _kpad(kp) + 4 * ((chunk * (kp // 4) + 31) // 32)
            + 4 * SPMV_ROWS * (kp // block_k)
            + (4 * SPMV_ROWS * SPMV_MAX_STREAMS if split > 1 else 0))


@functools.lru_cache(maxsize=512)
def spmv_launch_plan(o_dim: int, i_dim: int, ldw: int, block_k: int, b: int,
                     dtype: torch.dtype = torch.float32,
                     device: int = -1) -> SpmvLaunchPlan:
    """The launch plan of one call on ``w`` of type ``dtype`` (fp32 or
    bf16) with row stride ``ldw``, ``o_dim`` outputs, ``i_dim`` inputs and
    ``b`` streams. Raises ``ValueError`` for what no instance takes:
    ``block_k`` not a positive multiple of 4, ``ldw < i_dim``, a weight
    type the kernel does not read, or deltas of one stream that do not fit
    ``SMEM_OPTIN_BYTES``."""
    if dtype not in SPMV_DTYPES:
        raise ValueError(f"delta_spmv reads fp32 or bf16 weights, not "
                         f"{dtype}")
    if block_k <= 0 or block_k % 4 or ldw < i_dim:
        raise ValueError(f"delta_spmv takes block_k a positive multiple of "
                         f"4 and ldw >= I; got block_k={block_k}, "
                         f"ldw={ldw}, I={i_dim}")
    kp = -(-i_dim // block_k) * block_k
    nbk = kp // block_k
    vector = 16 // dtype.itemsize
    wide = ldw % vector == 0 and block_k % vector == 0
    if not wide:
        instance = "narrow"
    else:
        instance = "one_stream" if b == 1 else "tile"
    groups = -(-o_dim // SPMV_ROWS)
    split = max(1, min(SPMV_MAX_SPLIT, nbk, H100_SMS // groups))
    rows, grid = 1, groups * split
    resident = H100_SMS * SPMV_BLOCKS_PER_SM
    if instance == "one_stream" and split == 1 and groups > resident:
        # the blocks the SMs hold at once, two rows a warp (more blocks
        # where even that does not cover the output)
        rows = SPMV_MAX_ROWS
        grid = max(resident, -(-o_dim // (SPMV_ROWS * rows)))
    chunk = 1 if instance == "one_stream" else min(b, SPMV_MAX_STREAMS)
    while True:
        smem = spmv_smem_bytes(kp, block_k, chunk, split)
        if smem <= SMEM_OPTIN_BYTES or chunk == 1:
            break
        chunk -= 1
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"one stream's deltas at I={i_dim} need {smem} B "
                         f"of shared memory, more than {SMEM_OPTIN_BYTES}")
    elems = vector if wide else 1
    group = max(1, 32 * SPMV_UNROLL * elems // (block_k * rows))
    return SpmvLaunchPlan(instance=instance, chunk=chunk, split=split,
                          smem=smem, grid=grid, rows=rows, vector_elems=elems,
                          blocks_per_group=group, device=device)


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

    Returns ``[B, O]`` in ``acc``'s type (``w``'s without ``acc``). CUDA
    operands launch the kernel; CPU operands run :func:`delta_spmv_ref`.
    """
    operands = [t for t in (w, dx, acc) if t is not None]
    for t in operands:
        if t.dtype not in SPMV_DTYPES:
            raise TypeError(f"delta_spmv takes fp32 and bf16 operands, got "
                            f"{t.dtype}")
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
    fn = _build.load("delta_spmv.cu").delta_spmv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(w, dx, acc, o_dim: int, block_k: int) -> torch.Tensor:
    b, i_dim = dx.shape
    index = dx.device.index
    plan = spmv_launch_plan(o_dim, i_dim, w.shape[1], block_k, b, w.dtype,
                            -1 if index is None else index)
    require(w, "w", w.dtype, tuple(w.shape))
    require(dx, "dx", dx.dtype, (b, i_dim))
    if acc is not None:
        require(acc, "acc", acc.dtype, (b, o_dim))
    out_dtype = acc.dtype if acc is not None else w.dtype
    out = torch.empty((b, o_dim), dtype=out_dtype, device=dx.device)
    bf16 = torch.bfloat16
    err = _fn()(w.data_ptr(), dx.data_ptr(),
                acc.data_ptr() if acc is not None else None, out.data_ptr(),
                b, i_dim, o_dim, w.shape[1], block_k, int(w.dtype == bf16),
                int(dx.dtype == bf16),
                int(acc is not None and acc.dtype == bf16),
                int(out_dtype == bf16), SPMV_INSTANCES.index(plan.instance),
                plan.chunk, plan.split, plan.grid, plan.rows, plan.smem,
                plan.device, cuda_stream(dx))
    kinfo = DELTA_SPMV_BF16 if w.dtype == bf16 else DELTA_SPMV_F32
    if err:
        raise RuntimeError(f"{kinfo.name} launch failed: CUDA error {err}")
    kinfo.launches += 1
    return out


def delta_spmv_ref(w: torch.Tensor, dx: torch.Tensor,
                   acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version (the port of the JAX oracle ``delta_spmv_ref``):
    ``w: [O, I]``, ``dx: [B, I]``, ``acc: [B, O]``, each fp32 or bf16.
    The product and the sum with ``acc`` run in fp32 (a bf16 product is
    exact there), then one rounding to ``acc``'s type (``w``'s without
    ``acc``), as the kernel does. Blocks that no stream fired contribute
    exact zeros either way, so the dense product is the block-skipped one.
    On a CUDA device TF32 must be off for matmuls (PyTorch's default)."""
    out_dtype = acc.dtype if acc is not None else w.dtype
    out = dx.float() @ w.float().T
    if acc is not None:
        out = acc.float() + out
    return out.to(out_dtype)


def delta_spmv_hbm_bytes(w_shape, dx: torch.Tensor, block_k: int = 128,
                         weight_bytes: int = 2) -> torch.Tensor:
    """Model of the weight traffic of one call: fired column blocks times
    ``block_k`` columns times ``O`` rows (for the roofline and benches)."""
    o_dim, i_dim = w_shape
    b = dx.shape[0]
    dxp = torch.nn.functional.pad(dx, (0, (-i_dim) % block_k))
    fired = torch.any((dxp.reshape(b, -1, block_k) != 0), dim=2).any(dim=0)
    return torch.sum(fired) * block_k * o_dim * weight_bytes
