"""Fused DeltaGRU layer step (paper Figs. 6 + 7, Eq. 3), the PyTorch port of
:mod:`repro.kernels.deltagru_seq`.

One kernel launch per layer step: input and hidden deltas are concatenated
into one k-dimension so a single fired-block compaction drives a single
block-sparse matvec over the packed ``[3, Hp, Ip+Hk]`` volume, the
candidate gate's k-blocks route to ``M_xc`` or ``M_hc`` on the x/h seam,
and the Fig. 7 activation runs in the same kernel.

:func:`deltagru_seq_step` launches the CUDA kernel of
``csrc/deltagru_seq.cu`` for CUDA tensors and runs its plain version
:func:`deltagru_seq_step_ref` for CPU tensors. The int8 / int4 step lives
in :mod:`repro_torch.kernels.delta_q8`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.delta_q8 import (N_MEM, _GruBlockGeometry,
                                          layout_to, pack_cat_volume)
from repro_torch.kernels.delta_step_f32 import launch_f32_step
from repro_torch.kernels.ops import launches_kernel


@dataclass(frozen=True)
class FusedGruLayout(_GruBlockGeometry):
    """One DeltaGRU layer packed for the fused kernel (built once).

    ``w`` is ``[3, Hp, Ip + Hk]``: gate-major (r, u, c) rows, hidden dim
    padded to ``block_h``, input columns padded to ``block_k`` followed by
    hidden columns padded to ``block_k`` (a block-aligned x/h seam).
    """

    w: torch.Tensor
    input_size: int
    hidden_size: int
    block_h: int
    block_k: int

    def to(self, device) -> "FusedGruLayout":
        return layout_to(self, device)


def pack_gru_layer(w_x: torch.Tensor, w_h: torch.Tensor, block_h: int = 128,
                   block_k: int = 128) -> FusedGruLayout:
    """Pack ``w_x: [3H, I]`` and ``w_h: [3H, H]`` into the fused layout."""
    i_dim, h_dim = w_x.shape[-1], w_h.shape[-1]
    if w_x.shape[0] != 3 * h_dim or w_h.shape[0] != 3 * h_dim:
        raise ValueError(f"pack_gru_layer expects w_x [3H, I] / w_h [3H, H]; "
                         f"got {tuple(w_x.shape)} / {tuple(w_h.shape)}")
    return FusedGruLayout(
        w=pack_cat_volume(w_x.detach(), w_h.detach(), gates=3,
                          block_h=block_h, block_k=block_k),
        input_size=i_dim, hidden_size=h_dim,
        block_h=block_h, block_k=block_k)


def deltagru_seq_step(layout: FusedGruLayout, m_prev: torch.Tensor,
                      h_prev: torch.Tensor, dx: torch.Tensor,
                      dh: torch.Tensor):
    """One fp32 fused layer step on encoded deltas.

    ``m_prev: [B, 4H]``, ``h_prev: [B, H]``, ``dx: [B, I]``, ``dh: [B, H]``
    -> ``(m_new: [B, 4H], h_new: [B, H])``. CUDA operands launch the kernel;
    CPU operands run :func:`deltagru_seq_step_ref`.
    """
    if not launches_kernel(layout.w, m_prev, h_prev, dx, dh):
        return deltagru_seq_step_ref(layout, m_prev, h_prev, dx, dh)
    return launch_f32_step(layout, 3, m_prev, h_prev, dx, dh)


def deltagru_seq_step_ref(layout: FusedGruLayout, m_prev: torch.Tensor,
                          h_prev: torch.Tensor, dx: torch.Tensor,
                          dh: torch.Tensor):
    """Plain PyTorch version of the fused step (the port of the JAX oracle
    ``deltagru_seq_step_ref``). fp32 throughout; it sums in another order
    than the kernel, so the two agree within an fp32 bound, not bitwise. On
    a CUDA device TF32 must be off for matmuls (PyTorch's default)."""
    b = dx.shape[0]
    h_dim = layout.hidden_size
    w = layout.w.to(torch.float32)
    wx = w[:, :h_dim, :layout.input_size]            # [3, H, I]
    wh = w[:, :h_dim, layout.ip:layout.ip + h_dim]   # [3, H, H]
    px = torch.einsum("bi,ghi->bgh", dx.to(torch.float32), wx)
    ph = torch.einsum("bi,ghi->bgh", dh.to(torch.float32), wh)
    m = m_prev.reshape(b, N_MEM, h_dim).to(torch.float32)
    m_r = m[:, 0] + px[:, 0] + ph[:, 0]
    m_u = m[:, 1] + px[:, 1] + ph[:, 1]
    m_xc = m[:, 2] + px[:, 2]
    m_hc = m[:, 3] + ph[:, 2]
    r = torch.sigmoid(m_r)
    u = torch.sigmoid(m_u)
    c = torch.tanh(m_xc + r * m_hc)
    h_new = (1.0 - u) * c + u * h_prev.to(torch.float32)
    m_new = torch.stack([m_r, m_u, m_xc, m_hc], 1).reshape(b, N_MEM * h_dim)
    return m_new.to(m_prev.dtype), h_new.to(h_prev.dtype)

