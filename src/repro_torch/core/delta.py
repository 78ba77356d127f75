"""Delta-network state encoding (EdgeDRNN Eq. 2), the PyTorch port of
:mod:`repro.core.delta`.

Each temporally streamed vector ``s_t`` keeps a state memory ``s_hat``; an
element propagates only if it moved by at least ``theta`` since it last
propagated::

    delta_i = s_i - s_hat_i   if |s_i - s_hat_i| >= theta else 0
    s_hat_i = s_i             if |s_i - s_hat_i| >= theta else s_hat_i

The state memory is threaded explicitly (no hidden state), so the same
functions serve a Python loop over time and autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DeltaState(NamedTuple):
    """State memory for one delta-encoded stream (``s_hat`` in Eq. 2)."""

    memory: torch.Tensor

    @property
    def shape(self):
        return self.memory.shape


def init_delta_state(shape, dtype=torch.float32, device=None) -> DeltaState:
    """Zero-initialized state memory (paper: ``x_hat_0 = h_hat_-1 = 0``)."""
    return DeltaState(memory=torch.zeros(shape, dtype=dtype, device=device))


class DeltaEncodeOut(NamedTuple):
    delta: torch.Tensor   # sparse delta vector (exact value where fired)
    state: DeltaState     # updated state memory
    fired: torch.Tensor   # bool mask of elements that crossed the threshold


def delta_encode(s: torch.Tensor, state: DeltaState, theta) -> DeltaEncodeOut:
    """Eq. 2: threshold-gated delta encoding of one timestep.

    ``theta`` is a scalar, a 0-d tensor or a broadcastable tensor (>= 0);
    ``theta == 0`` degenerates to plain differencing.
    """
    raw = s - state.memory
    fired = torch.abs(raw) >= theta
    delta = torch.where(fired, raw, torch.zeros_like(raw))
    new_memory = torch.where(fired, s, state.memory)
    return DeltaEncodeOut(delta=delta, state=DeltaState(new_memory),
                          fired=fired)


class _StraightThrough(torch.autograd.Function):
    """Forward: the thresholded delta; backward: identity to ``raw``."""

    @staticmethod
    def forward(ctx, raw, delta):
        return delta

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def delta_encode_ste(s: torch.Tensor, state: DeltaState,
                     theta) -> DeltaEncodeOut:
    """Delta encode with a straight-through estimator for training.

    The forward is :func:`delta_encode`; the backward treats the
    thresholding as identity, so gradients reach ``s`` as if the delta
    were ``s - s_hat_{t-1}`` (the memory is not differentiated).
    """
    mem = state.memory.detach()
    out = delta_encode(s.detach(), DeltaState(mem), theta)
    delta = _StraightThrough.apply(s - mem, out.delta)
    return DeltaEncodeOut(delta=delta, state=out.state, fired=out.fired)


def delta_encode_sequence(xs: torch.Tensor, theta, time_axis: int = 0,
                          init: DeltaState | None = None):
    """Delta-encode a whole sequence (time on ``time_axis``).

    Returns ``(deltas, fired, final_state)`` with deltas/fired shaped like
    ``xs``.
    """
    xs_t = torch.movedim(xs, time_axis, 0)
    state = init if init is not None else init_delta_state(
        xs_t.shape[1:], xs_t.dtype, xs_t.device)
    deltas, fired = [], []
    for x in xs_t:
        out = delta_encode(x, state, theta)
        state = out.state
        deltas.append(out.delta)
        fired.append(out.fired)
    deltas = torch.movedim(torch.stack(deltas), 0, time_axis)
    fired = torch.movedim(torch.stack(fired), 0, time_axis)
    return deltas, fired, state


def reconstruct_from_deltas(deltas: torch.Tensor, time_axis: int = 0,
                            init: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of delta encoding: the cumulative sum of deltas (``s_hat``).

    With ``theta == 0`` this reconstructs the original sequence; with
    ``theta > 0`` the thresholded state-memory trajectory.
    """
    d = torch.movedim(deltas, time_axis, 0)
    if init is not None:
        d = d.clone()
        d[0] = d[0] + init
    return torch.movedim(torch.cumsum(d, dim=0), 0, time_axis)
