"""Device resolution, kernel dispatch by tensor device, and launch counts.

The counterpart of :mod:`repro.kernels.ops`. The JAX package picks a Pallas
mode from the default backend (compiled on a TPU, interpreted or the jnp
oracle elsewhere) and has a global ``set_force_ref`` switch. Here the rule
is the tensor's device, and nothing else:

* operands on the CPU run the kernel's plain PyTorch version;
* operands on a CUDA device launch the hand-written kernel, or raise.

There is no fallback from a failed launch to the plain version and no
global switch that reroutes the main path; callers that want the plain
version on the card call it by name (``*_ref``).

Every kernel wrapper adds one to its :class:`KernelInfo` ``launches`` count
where it launches its kernel, so a run can show that the main path went
through the kernels. A CUDA graph's capture calls the wrappers without
running a kernel and its replays run kernels without calling a wrapper, so
its owner takes the capture's counts back (:func:`take_back_launches`) and
adds them once per replay (:func:`add_launches`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for (or defaulted to) and no
    card is present — the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device: "cuda" means the current one
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def launches_kernel(*tensors: torch.Tensor) -> bool:
    """Dispatch rule: True when every operand lies on one CUDA device
    (launch the kernel), False when every operand lies on the CPU (run the
    plain version). Mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise before a launch that autograd would record: a kernel has no
    backward, and its ``torch.empty`` outputs carry no ``grad_fn``, so a
    gradient through it would be lost without a word. Callers that train
    through the function call its plain version (``*_ref``) by name."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: it is called on operands that require "
            "grad with grad mode on; call its plain version by name to "
            "differentiate through it")


# Streaming multiprocessors of an H100 SXM, for the launch plans.
H100_SMS = 132


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple, align: int = 16) -> torch.Tensor:
    """Check a kernel operand (device, dtype, shape, contiguity, alignment
    to ``align`` bytes) before its pointer is handed to CUDA; raise on
    anything the kernel does not take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
    return t


def aligned16(*tensors) -> bool:
    """True when every tensor given (None skipped) starts on 16 bytes: the
    kernels that also take 4-byte aligned operands pick their 16-byte
    loads by it."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def cuda_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream, for a kernel launched on
    ``t``'s device. A launch goes to the calling thread's current device,
    so ``t`` must live there."""
    current = torch.cuda.current_device()
    if t.device.index != current:
        raise ValueError(f"operands on {t.device} but the current CUDA "
                         f"device is cuda:{current}; call "
                         "torch.cuda.set_device first")
    return torch.cuda.current_stream().cuda_stream


@dataclass
class KernelInfo:
    """One hand-written kernel: where its source lives, which TPU kernel
    it replaces, and how many times the wrapper launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


DELTAGRU_SEQ_F32 = KernelInfo(
    "deltagru_seq_f32", "src/repro_torch/csrc/deltagru_seq.cu",
    "src/repro/kernels/deltagru_seq.py:111")
DELTA_Q8_GRU_I8 = KernelInfo(
    "delta_q8_gru_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:407")
DELTA_Q8_GRU_I4 = KernelInfo(
    "delta_q8_gru_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:407")
DELTALSTM_SEQ_F32 = KernelInfo(
    "deltalstm_seq_f32", "src/repro_torch/csrc/deltalstm_seq.cu",
    "src/repro/kernels/deltalstm_seq.py:119")
DELTA_Q8_LSTM_I8 = KernelInfo(
    "delta_q8_lstm_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:749")
DELTA_Q8_LSTM_I4 = KernelInfo(
    "delta_q8_lstm_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:749")
# the buffered instances (the TPU's double-buffered kernels), reached
# through buffered=True
DELTA_Q8_GRU_DBUF_I8 = KernelInfo(
    "delta_q8_gru_dbuf_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:600")
DELTA_Q8_GRU_DBUF_I4 = KernelInfo(
    "delta_q8_gru_dbuf_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:600")
DELTA_Q8_LSTM_DBUF_I8 = KernelInfo(
    "delta_q8_lstm_dbuf_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:874")
DELTA_Q8_LSTM_DBUF_I4 = KernelInfo(
    "delta_q8_lstm_dbuf_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:874")
# the kernels of the delta-ized LM cells and the composed GRU step
DELTA_SPMV_F32 = KernelInfo(
    "delta_spmv_f32", "src/repro_torch/csrc/delta_spmv.cu",
    "src/repro/kernels/delta_spmv.py:33")
# the bf16-weight instance of the same kernel, reached through delta_spmv
# on bf16 weights
DELTA_SPMV_BF16 = KernelInfo(
    "delta_spmv_bf16", "src/repro_torch/csrc/delta_spmv.cu",
    "src/repro/kernels/delta_spmv.py:33")
RGLRU_SCAN_F32 = KernelInfo(
    "rglru_scan_f32", "src/repro_torch/csrc/rglru_scan.cu",
    "src/repro/kernels/rglru_scan.py:20")
RWKV6_SCAN_F32 = KernelInfo(
    "rwkv6_scan_f32", "src/repro_torch/csrc/rwkv6_scan.cu",
    "src/repro/kernels/rwkv6_scan.py:24")
# the bf16 r, k, v instance of the same kernel, reached through rwkv6_scan
# on bf16 operands (the bf16 RWKV6 models)
RWKV6_SCAN_BF16 = KernelInfo(
    "rwkv6_scan_bf16", "src/repro_torch/csrc/rwkv6_scan.cu",
    "src/repro/kernels/rwkv6_scan.py:24")
DELTAGRU_ACT_F32 = KernelInfo(
    "deltagru_act_f32", "src/repro_torch/csrc/deltagru_cell.cu",
    "src/repro/kernels/deltagru_cell.py:24")
KERNELS = (DELTAGRU_SEQ_F32, DELTA_Q8_GRU_I8, DELTA_Q8_GRU_I4,
           DELTALSTM_SEQ_F32, DELTA_Q8_LSTM_I8, DELTA_Q8_LSTM_I4,
           DELTA_Q8_GRU_DBUF_I8, DELTA_Q8_GRU_DBUF_I4,
           DELTA_Q8_LSTM_DBUF_I8, DELTA_Q8_LSTM_DBUF_I4,
           DELTA_SPMV_F32, DELTA_SPMV_BF16, RGLRU_SCAN_F32, RWKV6_SCAN_F32,
           RWKV6_SCAN_BF16, DELTAGRU_ACT_F32)


def q8_kernel(gates: int, weight_bits: int, buffered: bool) -> KernelInfo:
    """The int8 / int4 kernel instance of a cell (3 gate rows: GRU, 4:
    LSTM), a weight width and the buffered flag."""
    cell = "gru" if gates == 3 else "lstm"
    name = f"delta_q8_{cell}{'_dbuf' if buffered else ''}_i{weight_bits}"
    return next(k for k in KERNELS if k.name == name)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def take_back_launches(before: dict) -> tuple:
    """Set every count back to ``before`` (a :func:`launch_counts`) and
    return what was counted since, as ``((KernelInfo, n), ...)``. A CUDA
    graph capture calls every wrapper of the step once but runs no kernel:
    its counts are taken back, and :func:`add_launches` adds them once per
    replay, when the kernels do run."""
    counted = tuple((k, k.launches - before[k.name]) for k in KERNELS
                    if k.launches != before[k.name])
    for k, n in counted:
        k.launches -= n
    return counted


def add_launches(counted: tuple) -> None:
    """Add the launches of one replay of a captured graph
    (:func:`take_back_launches`)."""
    for k, n in counted:
        k.launches += n


# -- the public kernel ops of the JAX package (repro.kernels.ops) ------------
# Each dispatches by the operands' device inside its kernel module; the
# modules import this one, so they are imported here at call time.

def delta_spmv(w: torch.Tensor, dx: torch.Tensor,
               acc: torch.Tensor | None = None, *, block_k: int = 128,
               packed: bool = False,
               out_dim: int | None = None) -> torch.Tensor:
    """Block-column-skipping ``acc + dx @ w.T`` (the paper's sparse MxV);
    :func:`repro_torch.kernels.delta_spmv.delta_spmv`."""
    from repro_torch.kernels.delta_spmv import delta_spmv as _spmv
    return _spmv(w, dx, acc, block_k=block_k, packed=packed,
                 out_dim=out_dim)


def deltagru_act(m_prev: torch.Tensor, zx: torch.Tensor, zh: torch.Tensor,
                 h_prev: torch.Tensor):
    """Fused DeltaGRU pointwise pipeline (paper Fig. 7);
    :func:`repro_torch.kernels.deltagru_cell.deltagru_act`."""
    from repro_torch.kernels.deltagru_cell import deltagru_act as _act
    return _act(m_prev, zx, zh, h_prev)


def rwkv6_scan(r, k, v, w, u, s0=None):
    """WKV6 recurrence over ``[B, H, T, D]``;
    :func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan`."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _scan
    return _scan(r, k, v, w, u, s0)


def rwkv6_chunked(r, k, v, w, u, s0=None, *, chunk: int = 16):
    """Chunk-parallel WKV6 (matmul form, differentiable, plain PyTorch on
    any device): the same function as :func:`rwkv6_scan`. Pads T to a chunk
    multiple with ``w = 1`` and ``k = 0``, which freeze the state."""
    from repro_torch.kernels.ref import rwkv6_chunked_ref
    t = r.shape[2]
    pad = (-t) % chunk
    if pad:
        pd = (0, 0, 0, pad)
        r, k, v = (torch.nn.functional.pad(z, pd) for z in (r, k, v))
        w = torch.nn.functional.pad(w, pd, value=1.0)
    y, s_t = rwkv6_chunked_ref(r, k, v, w, u, s0, chunk=chunk)
    return y[:, :, :t], s_t


def rglru_scan(x, a, h0=None):
    """RG-LRU diagonal recurrence over ``[B, T, D]``;
    :func:`repro_torch.kernels.rglru_scan.rglru_scan`."""
    from repro_torch.kernels.rglru_scan import rglru_scan as _scan
    return _scan(x, a, h0)


def deltagru_cell_fused(w_x: torch.Tensor, w_h: torch.Tensor,
                        m_prev: torch.Tensor, h_prev: torch.Tensor,
                        dx: torch.Tensor, dh: torch.Tensor):
    """The full DeltaGRU step as the FPGA runs it: two sparse MxVs
    (``w_x: [3H, I]``, ``w_h: [3H, H]``, unpacked) and the activation
    pipeline, three launches on a CUDA device."""
    zx = delta_spmv(w_x, dx)
    zh = delta_spmv(w_h, dh)
    return deltagru_act(m_prev, zx, zh, h_prev)
