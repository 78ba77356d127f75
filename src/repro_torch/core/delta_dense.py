"""Delta-linear: the paper's column skipping for any linear layer, the
PyTorch port of :mod:`repro.core.delta_dense`.

For a fixed weight ``W`` applied to a temporally correlated stream ``x_t``
(RNN states, autoregressive decode activations, streaming audio frames):

    y_t = W x_t  ==  M_t   where   M_t = M_{t-1} + W (x_t - x_hat_{t-1})

Thresholding the delta makes the contraction dimension sparse: a column of
``W`` whose input did not move by θ is not needed
(:func:`repro_torch.kernels.delta_spmv.delta_spmv` skips whole blocks of
them). ``DeltaLinearState`` is carried explicitly, so the op composes with
a decode loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.delta import DeltaState, delta_encode, init_delta_state
from repro_torch.core.sparsity import recip_mean
from repro_torch.kernels.ops import resolve_device


class DeltaLinearState(NamedTuple):
    x_mem: DeltaState     # [..., I] last propagated input
    m: torch.Tensor       # [..., O] accumulated output (delta memory)


def init_delta_linear_state(in_dim: int, out_dim: int, batch_shape=(),
                            dtype=torch.float32,
                            bias: torch.Tensor | None = None,
                            device=None) -> DeltaLinearState:
    """Init with M = bias (the paper's consume-bias-once convention), on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    m0 = torch.zeros((*batch_shape, out_dim), dtype=dtype, device=dev)
    if bias is not None:
        m0 = m0 + bias.to(dtype=dtype, device=dev)
    return DeltaLinearState(
        x_mem=init_delta_state((*batch_shape, in_dim), dtype, dev), m=m0)


class DeltaLinearOut(NamedTuple):
    y: torch.Tensor
    state: DeltaLinearState
    fired_fraction: torch.Tensor  # scalar: fraction of inputs that fired


def delta_linear(w: torch.Tensor, x: torch.Tensor, state: DeltaLinearState,
                 theta, matvec: Callable | None = None) -> DeltaLinearOut:
    """One streamed application of ``y = W x`` via delta accumulation.

    Args:
      w: ``[O, I]`` weight.
      x: ``[..., I]`` current input.
      state: delta-linear state (input memory + output memory).
      theta: delta threshold (0 => exact).
      matvec: optional sparse product ``matvec(w, dx) -> [..., O]``; the
        default is the dense ``dx @ w.T``.
    """
    enc = delta_encode(x, state.x_mem, theta)
    mv = matvec if matvec is not None else (lambda wt, v: v @ wt.T)
    m = state.m + mv(w, enc.delta)
    fired = recip_mean(enc.fired.to(torch.float32))
    return DeltaLinearOut(y=m, state=DeltaLinearState(enc.state, m),
                          fired_fraction=fired)


def delta_linear_reference(w: torch.Tensor, xs: torch.Tensor,
                           theta) -> torch.Tensor:
    """Oracle: run the streamed delta-linear over ``xs: [T, ..., I]`` and
    return ``ys: [T, ..., O]``. At ``theta=0`` it is ``xs @ w.T`` up to the
    rounding of the running sum."""
    state = init_delta_linear_state(w.shape[1], w.shape[0], xs.shape[1:-1],
                                    xs.dtype, device=xs.device)
    ys = []
    for x in xs:
        out = delta_linear(w, x, state, theta)
        state = out.state
        ys.append(out.y)
    return torch.stack(ys)
