"""Fused DeltaLSTM layer step (the Fig. 6/7 pipeline on the LSTM cell), the
PyTorch port of :mod:`repro.kernels.deltalstm_seq`.

One kernel launch per layer step over the concatenated ``[4, Hp, Ip+Hk]``
volume (gate-major ``i, f, g, o`` rows; input then hidden columns, each
padded to ``block_k``): one fired-block compaction drives one block-sparse
matvec. Unlike the GRU, each of the four delta memories ``M_i, M_f, M_g,
M_o`` takes both streams, so every fired block adds to all four and there
is no seam routing; the activation stage ``c = f·c_prev + i·g``,
``h = o·tanh(c)`` runs in the same kernel.

:func:`deltalstm_seq_step` launches the CUDA kernel of
``csrc/deltalstm_seq.cu`` for CUDA tensors and runs its plain version
:func:`deltalstm_seq_step_ref` for CPU tensors. The int8 / int4 LSTM step
lives in the cell-agnostic :mod:`repro_torch.kernels.delta_q8`; this module
re-exports its LSTM spellings (:class:`QuantLstmLayout`,
:func:`pack_lstm_weights_q8`, :func:`deltalstm_q8_step`,
:func:`deltalstm_q8_step_ref`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.delta_q8 import (  # noqa: F401  (re-exports)
    N_MEM, QuantDeltaLayout, _GruBlockGeometry, deltalstm_q8_step,
    deltalstm_q8_step_ref, layout_to, pack_cat_volume, pack_delta_weights_q8)
from repro_torch.kernels.delta_step_f32 import launch_f32_step
from repro_torch.kernels.ops import launches_kernel

# LSTM-pinned alias of the shared quantized layout (``gates=4`` instances).
QuantLstmLayout = QuantDeltaLayout


def pack_lstm_weights_q8(w_x: torch.Tensor, w_h: torch.Tensor,
                         b: torch.Tensor | None = None, block_h: int = 128,
                         block_k: int = 128, act_frac_bits: int = 8,
                         act_int_bits: int = 8, lut_frac_bits: int = 4,
                         with_ref_codes: bool | None = None
                         ) -> QuantDeltaLayout:
    """LSTM spelling of :func:`~repro_torch.kernels.delta_q8.\
pack_delta_weights_q8` (``gates=4``)."""
    return pack_delta_weights_q8(
        w_x, w_h, b=b, gates=4, block_h=block_h, block_k=block_k,
        act_frac_bits=act_frac_bits, act_int_bits=act_int_bits,
        lut_frac_bits=lut_frac_bits, with_ref_codes=with_ref_codes)


@dataclass(frozen=True)
class FusedLstmLayout(_GruBlockGeometry):
    """One DeltaLSTM layer packed for the fused kernel (built once).

    ``w`` is ``[4, Hp, Ip + Hk]``: gate-major (i, f, g, o) rows, hidden dim
    padded to ``block_h``, input columns padded to ``block_k`` followed by
    hidden columns padded to ``block_k``. It shares the block geometry of
    :class:`~repro_torch.kernels.deltagru_seq.FusedGruLayout`.
    """

    w: torch.Tensor
    input_size: int
    hidden_size: int
    block_h: int
    block_k: int

    def to(self, device) -> "FusedLstmLayout":
        return layout_to(self, device)


def pack_lstm_layer(w_x: torch.Tensor, w_h: torch.Tensor, block_h: int = 128,
                    block_k: int = 128) -> FusedLstmLayout:
    """Pack ``w_x: [4H, I]`` and ``w_h: [4H, H]`` into the fused layout."""
    i_dim, h_dim = w_x.shape[-1], w_h.shape[-1]
    if w_x.shape[0] != 4 * h_dim or w_h.shape[0] != 4 * h_dim:
        raise ValueError(f"pack_lstm_layer expects w_x [4H, I] / w_h [4H, H];"
                         f" got {tuple(w_x.shape)} / {tuple(w_h.shape)}")
    return FusedLstmLayout(
        w=pack_cat_volume(w_x.detach(), w_h.detach(), gates=4,
                          block_h=block_h, block_k=block_k),
        input_size=i_dim, hidden_size=h_dim,
        block_h=block_h, block_k=block_k)


def deltalstm_seq_step(layout: FusedLstmLayout, m_prev: torch.Tensor,
                       h_prev: torch.Tensor, c_prev: torch.Tensor,
                       dx: torch.Tensor, dh: torch.Tensor):
    """One fp32 fused LSTM layer step on encoded deltas.

    ``m_prev: [B, 4H]``, ``h_prev: [B, H]``, ``c_prev: [B, H]``,
    ``dx: [B, I]``, ``dh: [B, H]`` -> ``(m_new: [B, 4H], h_new: [B, H],
    c_new: [B, H])``. ``h_prev`` keeps the JAX signature; ``h = o·tanh(c)``
    never reads it, so the kernel is not handed it. CUDA operands launch
    the kernel; CPU operands run :func:`deltalstm_seq_step_ref`.
    """
    if not launches_kernel(layout.w, m_prev, h_prev, c_prev, dx, dh):
        return deltalstm_seq_step_ref(layout, m_prev, h_prev, c_prev, dx, dh)
    return launch_f32_step(layout, 4, m_prev, c_prev, dx, dh)


def deltalstm_seq_step_ref(layout: FusedLstmLayout, m_prev: torch.Tensor,
                           h_prev: torch.Tensor, c_prev: torch.Tensor,
                           dx: torch.Tensor, dh: torch.Tensor):
    """Plain PyTorch version of the fused LSTM step (the port of the JAX
    oracle ``deltalstm_seq_step_ref``, with its order of sums
    ``(m + px) + ph``). fp32 throughout; the kernel sums in another order,
    so the two agree within an fp32 bound, not bitwise. On a CUDA device
    TF32 must be off for matmuls (PyTorch's default)."""
    b = dx.shape[0]
    h_dim = layout.hidden_size
    w = layout.w.to(torch.float32)
    wx = w[:, :h_dim, :layout.input_size]            # [4, H, I]
    wh = w[:, :h_dim, layout.ip:layout.ip + h_dim]   # [4, H, H]
    px = torch.einsum("bi,ghi->bgh", dx.to(torch.float32), wx)
    ph = torch.einsum("bi,ghi->bgh", dh.to(torch.float32), wh)
    m = m_prev.reshape(b, N_MEM, h_dim).to(torch.float32) + px + ph
    gi = torch.sigmoid(m[:, 0])
    gf = torch.sigmoid(m[:, 1])
    gg = torch.tanh(m[:, 2])
    go = torch.sigmoid(m[:, 3])
    c_new = gf * c_prev.to(torch.float32) + gi * gg
    h_new = go * torch.tanh(c_new)
    return (m.reshape(b, N_MEM * h_dim).to(m_prev.dtype),
            h_new.to(h_prev.dtype), c_new.to(c_prev.dtype))
