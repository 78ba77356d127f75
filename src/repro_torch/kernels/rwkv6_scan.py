"""WKV6 recurrence (RWKV-6 "Finch"), the PyTorch port of
:mod:`repro.kernels.rwkv6_scan`.

Per (stream, head) the state ``S: [D, D]`` (key-dim x value-dim, D = 64)
evolves with a data-dependent per-key decay ``w_t`` in (0, 1) and a bonus
``u`` on the current token::

    y_t = r_t (S + diag(u) k_t^T v_t)
    S  <- diag(w_t) S + k_t^T v_t

:func:`rwkv6_scan` launches the CUDA kernel of ``csrc/rwkv6_scan.cu`` for
CUDA tensors and runs the plain version :func:`rwkv6_scan_batched_ref` for
CPU tensors. The kernel has two instances: every operand fp32
(``rwkv6_scan_f32``), or ``r, k, v`` in bf16 with ``w``, ``u``, the state
and ``y`` fp32 (``rwkv6_scan_bf16``, the bf16 RWKV6 models). The bf16 one
computes what the plain version computes under PyTorch's type promotion,
which is JAX's: ``k_t^T v_t`` is a bf16 product (rounded to bf16), and
everything it meets after that is fp32. :func:`rwkv6_scan_plan` is the
launch plan (the kernel by T: one step at a time at T <= 1, a chunk of
steps staged in shared memory at T > 1; the value columns a block handles,
the chunk, the grid, the vector width), computed on the host once per
shape, type, alignment and device and cached, so a launch makes no CUDA
API query; the C entry refuses a plan it cannot run.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (H100_SMS, RWKV6_SCAN_BF16,
                                     RWKV6_SCAN_F32, aligned16, cuda_stream,
                                     launches_kernel, refuse_autograd,
                                     require, scan_trips)

HEAD_DIM = 64                  # the only head size the kernel takes: kD
# Constants of csrc/rwkv6_scan.cu the plan mirrors. The one-step kernel:
RWKV6_VEC = 4                  # value columns a thread owns: kVec
RWKV6_COLS = 16                # value columns of a work unit: kCols
RWKV6_THREADS_PER_SM = 2048    # residency its launch bounds ask: kThreadsPerSM
# The chunked kernel (T > 1):
RWKV6_KEYS = 4                 # keys a thread owns: kKeys
RWKV6_CHUNK = 32               # the most steps a chunk stages: kChunk
RWKV6_CHUNK_COLS = (64, 32, 16)  # value columns a block may take
RWKV6_CHUNK_BLOCKS_PER_SM = 2  # its launch bounds' residency at 256 threads
# An H100 SM's shared memory: 228 KB, of which a block takes at most
# 227 KB, and 1 KB the system keeps a block.
SM_SHARED_BYTES = 228 * 1024
BLOCK_SHARED_BYTES = 227 * 1024
BLOCK_SHARED_RESERVED = 1024
DEFAULT_SHARED_BYTES = 48 * 1024  # above it: rwkv6_scan_prepare


@dataclass(frozen=True)
class Rwkv6ScanPlan:
    """How one ``rwkv6_scan`` call launches (:func:`rwkv6_scan_plan`).

    A work unit is one (stream, head) and ``cols`` of its 64 value
    columns; there are ``units = B * H * 64 / cols``; the ``grid`` blocks
    take units ``blockIdx, blockIdx + grid, ...``. ``chunk == 0``: the
    one-step kernel; ``cols`` is ``RWKV6_COLS`` and a block of ``threads =
    16 * cols`` threads gives thread ``(i, q)`` key ``i`` and the columns
    ``4q .. 4q + 3`` of its unit. ``chunk > 0``: the chunked kernel, which
    stages ``chunk`` steps at a time in ``smem`` bytes of shared memory; a
    block of ``threads = 4 * cols`` threads gives lane ``l = lane % 16`` of
    warp ``wp`` keys ``4l .. 4l + 3`` of the columns ``8 wp + 4 (lane //
    16) + (0 .. 3)``. ``vec``: 4 (16-byte loads, stores and copies) or 1
    (one element at a time). ``device``: the CUDA device index (-1 for
    none)."""

    cols: int
    threads: int
    units: int
    grid: int
    vec: int
    device: int
    chunk: int = 0
    smem: int = 0


def rwkv6_resident_blocks(threads: int) -> int:
    """Blocks of ``threads`` the SMs of an H100 hold at once at the
    one-step kernel's launch bounds."""
    return H100_SMS * (RWKV6_THREADS_PER_SM // threads)


def rwkv6_chunk_smem(chunk: int, cols: int, dtype: torch.dtype) -> int:
    """Shared memory of a chunked block (``chunk_smem`` of the source): two
    buffers of ``chunk`` + 1 rows (a spare one) of fp32 ``w`` and of ``r,
    k`` (64 keys) and ``v`` (``cols`` columns) in ``dtype``."""
    return 2 * (chunk + 1) * (HEAD_DIM * 4
                              + (2 * HEAD_DIM + cols) * dtype.itemsize)


def rwkv6_chunk_resident_blocks(threads: int, smem: int) -> int:
    """Blocks of the chunked kernel, ``threads`` and ``smem`` bytes each,
    the SMs of an H100 hold at once: its launch bounds give 2 blocks of
    256 threads an SM (at most 128 registers a thread), and the SM's
    shared memory as much as it holds."""
    by_regs = RWKV6_CHUNK_BLOCKS_PER_SM * 256 // threads
    by_smem = SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVED)
    return H100_SMS * min(by_regs, by_smem, 32)


@functools.lru_cache(maxsize=512)
def rwkv6_scan_plan(b: int, h: int, t: int, d: int,
                    dtype: torch.dtype = torch.float32, aligned: bool = True,
                    device: int = -1) -> Rwkv6ScanPlan:
    """The launch plan of a call over ``[b, h, t, d]`` operands whose
    ``r, k, v`` are of type ``dtype`` (fp32 or bf16; the others are fp32);
    ``aligned``: every operand starts on 16 bytes.

    At ``t <= 1`` the one-step kernel: a block handles ``RWKV6_COLS`` value
    columns of a head (128 blocks at the decode shape B = 1, H = 32); the
    grid is at most the blocks the SMs hold at once. At ``t > 1`` the
    chunked kernel: chunks of ``min(t, RWKV6_CHUNK)`` steps; a block
    handles the most columns of ``RWKV6_CHUNK_COLS`` (a whole head: r, k, w
    staged once) that still give 3/4 of the SMs a block, else 16; the grid
    is at most the blocks the SMs hold at once at the block's shared
    memory. Raises ``ValueError`` for what the kernel does not take:
    ``d != 64``, negative sizes, ``r, k, v`` neither fp32 nor bf16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rwkv6_scan takes fp32 or bf16 r, k, v, not "
                         f"{dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"rwkv6_scan takes a head size of {HEAD_DIM}, "
                         f"not {d}")
    if min(b, h, t) < 0:
        raise ValueError(f"rwkv6_scan takes sizes >= 0; got B={b}, H={h}, "
                         f"T={t}")
    vec = RWKV6_VEC if aligned else 1
    if t <= 1:
        threads = HEAD_DIM * RWKV6_COLS // RWKV6_VEC
        units = b * h * (HEAD_DIM // RWKV6_COLS)
        grid = min(units, rwkv6_resident_blocks(threads))
        return Rwkv6ScanPlan(cols=RWKV6_COLS, threads=threads, units=units,
                             grid=grid, vec=vec, device=device)
    chunk = min(t, RWKV6_CHUNK)
    cols = next((c for c in RWKV6_CHUNK_COLS
                 if 4 * b * h * (HEAD_DIM // c) >= 3 * H100_SMS),
                RWKV6_CHUNK_COLS[-1])
    threads = 4 * cols
    units = b * h * (HEAD_DIM // cols)
    smem = rwkv6_chunk_smem(chunk, cols, dtype)
    grid = min(units, rwkv6_chunk_resident_blocks(threads, smem))
    return Rwkv6ScanPlan(cols=cols, threads=threads, units=units, grid=grid,
                         vec=vec, device=device, chunk=chunk, smem=smem)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None):
    """WKV6 over ``r, k, v, w: [B, H, T, D]`` with bonus ``u: [H, D]`` and
    initial state ``s0: [B, H, D, D]`` (zeros if None); ``w`` is the decay
    factor in (0, 1). ``r, k, v`` are fp32 or bf16, everything else fp32.
    Returns ``(y: [B, H, T, D], s_T: [B, H, D, D])``, both fp32 (on the
    card at T > 1, where ``r, k, v, w`` are [B, H, T, D] views of
    contiguous [B, T, H, D] tensors, as the model hands them, ``y`` is
    such a view too: nothing is transposed in memory). The kernel has no
    backward: on operands that require grad, with grad mode
    on, a CUDA call raises (call :func:`rwkv6_scan_batched_ref` to
    differentiate)."""
    operands = [t for t in (r, k, v, w, u, s0) if t is not None]
    if not launches_kernel(*operands):
        return rwkv6_scan_batched_ref(r, k, v, w, u, s0)
    refuse_autograd("rwkv6_scan", *operands)
    return _launch(r, k, v, w, u, s0)


def _fn(name: str):
    fn = getattr(_build.load("rwkv6_scan.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_PREPARED: set = set()


def prepare(index: int, needed: bool) -> None:
    """Let the chunked kernel take more than 48 KB of shared memory on
    CUDA device ``index`` (``rwkv6_scan_prepare``), once a device. It is a
    setting of the device, not work on a stream, so it is made outside any
    capture: at the first launch of either kernel on the device that is
    not captured, whatever its T (an engine that meets a new prompt length
    captures it without a warm-up; the warm-up of its first length, T = 1
    or not, made the setting). ``needed``: this launch's plan takes more
    than 48 KB; a first launch inside a capture raises only then."""
    if index in _PREPARED:
        return
    if torch.cuda.is_current_stream_capturing():
        if needed:
            raise RuntimeError("rwkv6_scan: the chunked kernel's first "
                               f"launch on cuda:{index} is inside a CUDA "
                               "graph capture; launch rwkv6_scan once "
                               "outside the capture first")
        return
    lib = _build.load("rwkv6_scan.cu")
    lib.rwkv6_scan_prepare.restype = ctypes.c_int
    with torch.cuda.device(index):
        err = lib.rwkv6_scan_prepare()
    if err:
        raise RuntimeError(f"rwkv6_scan_prepare failed: CUDA error {err}")
    _PREPARED.add(index)


def _launch(r, k, v, w, u, s0):
    """Check the operands, plan and launch."""
    b, h, t, d = r.shape
    f32 = torch.float32
    in_dt = torch.bfloat16 if r.dtype == torch.bfloat16 else f32
    kinfo = RWKV6_SCAN_BF16 if in_dt == torch.bfloat16 else RWKV6_SCAN_F32
    # the chunked kernel (T > 1) reads and writes the model's [B, T, H, D]
    # layout in place: operands that are [B, H, T, D] views of contiguous
    # [B, T, H, D] tensors are not copied, and y comes back as such a view
    tmajor = (t > 1 and not all(z.is_contiguous() for z in (r, k, v, w))
              and all(z.movedim(1, 2).is_contiguous() for z in (r, k, v, w)))
    if tmajor:
        r, k, v, w = (z.movedim(1, 2) for z in (r, k, v, w))
        shape = (b, t, h, d)
    else:
        r, k, v, w = (z.contiguous() for z in (r, k, v, w))
        shape = (b, h, t, d)
    for z, name in ((r, "r"), (k, "k"), (v, "v")):
        require(z, name, in_dt, shape, align=in_dt.itemsize)
    require(w, "w", f32, shape, align=4)
    require(u, "u", f32, (h, d), align=4)
    if s0 is not None:
        require(s0, "s0", f32, (b, h, d, d), align=4)
    y = torch.empty(shape, dtype=f32, device=r.device)
    s_t = torch.empty((b, h, d, d), dtype=f32, device=r.device)
    index = r.device.index
    plan = rwkv6_scan_plan(b, h, t, d, r.dtype,
                           aligned16(r, k, v, w, u, s0, y, s_t),
                           -1 if index is None else index)
    prepare(index, plan.smem > DEFAULT_SHARED_BYTES)
    err = _fn(kinfo.name)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        0 if s0 is None else s0.data_ptr(), y.data_ptr(), s_t.data_ptr(), b,
        h, t, d, plan.cols, plan.chunk, int(tmajor), plan.vec, plan.grid,
        cuda_stream(r))
    if err:
        raise RuntimeError(f"{kinfo.name} launch failed: CUDA error {err}")
    kinfo.launches += 1
    return (y.movedim(1, 2) if tmajor else y), s_t


def rwkv6_scan_batched_ref(r, k, v, w, u, s0=None):
    """Plain version over ``r, k, v, w: [B, H, T, D]``, ``u: [H, D]`` (the
    port of the JAX oracle ``rwkv6_scan_batched_ref``): a loop over T of the
    per-step update, all streams and heads at once, under PyTorch's type
    promotion, which is JAX's: with bf16 ``r, k, v`` and fp32 ``w, u, s0``
    the outer product ``kv`` is bf16 and everything after it fp32. (A
    matmul does not promote in PyTorch, so ``r_t`` is cast to the type of
    the matrix it meets, as ``jnp.matmul`` promotes it.)"""
    b, h, t, d = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), device=r.device,
                         dtype=torch.promote_types(r.dtype, w.dtype))
    ys, (s,) = scan_trips(_wkv_step, (s0,), (r, k, v, w), (u,), dim=2)
    return ys, s


def _wkv_step(carry, r_t, k_t, v_t, w_t, u):
    (s,) = carry
    kv = k_t[..., :, None] * v_t[..., None, :]                   # [B,H,D,D]
    m = s + u[:, :, None] * kv
    y = (r_t[..., None, :].to(m.dtype) @ m)[..., 0, :]
    return (w_t[..., :, None] * s + kv,), y


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """Single-head plain version: ``r, k, v, w: [T, D]``, ``u: [D]``,
    ``s0: [D, D]``. Returns ``(y: [T, D], S_T)``."""
    y, s = rwkv6_scan_batched_ref(
        r[None, None], k[None, None], v[None, None], w[None, None], u[None],
        None if s0 is None else s0[None, None])
    return y[0, 0], s[0, 0]
