"""RecurrentGemma / Griffin recurrent block: temporal conv1d(4) + RG-LRU,
the PyTorch port of :mod:`repro.models.rglru`.

The recurrence over a sequence runs through
:func:`repro_torch.kernels.ops.rglru_scan` (the CUDA kernel on a CUDA
device, its plain version on the CPU) when :func:`rglru_block_apply` is
asked for the kernel, and through the plain version
:func:`repro_torch.kernels.rglru_scan.rglru_scan_batched_ref`, by name,
otherwise (the default, as the reference's ``use_kernel=False``): the
kernel has no backward, so a differentiated call takes the plain scan.
At T > 1 with ``REPRO_RGLRU_ASSOC=1`` in the environment (read at call
time, as the reference reads it) the block takes the log-depth
associative scan :func:`repro_torch.kernels.ref.rglru_assoc_ref`
instead, whatever ``use_kernel`` says.

The gate expressions live in :mod:`repro_torch.core.deltarglru`, so the
delta decode and :func:`rglru_block_decode` share one set of ops: that is
what makes the θ=0 delta decode bitwise equal to the block decode.
"""
from __future__ import annotations

import os

from typing import NamedTuple

import torch

from repro_torch.core.deltarglru import _C, CONV_WIDTH, gelu, rglru_gates
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rglru_assoc_ref
from repro_torch.kernels.rglru_scan import rglru_scan_batched_ref
from repro_torch.models.common import dense_init


def init_rglru_block(generator: torch.Generator, d_model: int,
                     lru_width: int | None = None,
                     dtype=torch.float32) -> dict:
    """One recurrent block drawn from ``generator`` on its device (the JAX
    recipe: ``λ = softplus⁻¹(-log a / c)`` with ``a ~ U[0.9, 0.999]``,
    truncated-normal fan-in projections, conv weights ``N(0, 1/4)``, zero
    biases)."""
    w = lru_width or d_model
    dev = generator.device
    a = 0.9 + 0.099 * torch.rand((w,), generator=generator,
                                 dtype=torch.float32, device=dev)
    lam = torch.log(torch.expm1(-torch.log(a) / _C))
    conv_w = torch.randn((CONV_WIDTH, w), generator=generator,
                         dtype=torch.float32, device=dev) * CONV_WIDTH ** -0.5
    return {
        "w_in": dense_init(generator, d_model, w, dtype),       # recurrent
        "w_in_gate": dense_init(generator, d_model, w, dtype),  # gelu gate
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_rg": dense_init(generator, w, w, dtype),   # recurrence gate
        "w_ig": dense_init(generator, w, w, dtype),   # input gate
        "b_rg": torch.zeros((w,), dtype=dtype, device=dev),
        "b_ig": torch.zeros((w,), dtype=dtype, device=dev),
        "lambda": lam,                                # [w] f32
        "w_out": dense_init(generator, w, d_model, dtype),
    }


def assoc_route() -> bool:
    """True when ``REPRO_RGLRU_ASSOC=1`` is in the environment: the blocks
    then take the associative scan at T > 1. Read at each call; a captured
    prefill keeps the route that was live at its capture, so
    :class:`repro_torch.serve.engine.LmEngine` keys its prefill graphs on
    this."""
    return os.environ.get("REPRO_RGLRU_ASSOC", "0") == "1"


class RglruState(NamedTuple):
    h: torch.Tensor      # [B, W] recurrent state
    conv: torch.Tensor   # [B, CONV_WIDTH-1, W] trailing inputs of the conv


def init_rglru_state(batch: int, width: int, dtype=torch.float32,
                     device=None) -> RglruState:
    return RglruState(
        h=torch.zeros((batch, width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_WIDTH - 1, width), dtype=dtype,
                         device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None):
    """Causal depthwise conv1d over ``x: [B, T, W]`` (kernel width 4).
    Returns ``(out, new_history)``."""
    if history is None:
        history = x.new_zeros((x.shape[0], CONV_WIDTH - 1, x.shape[-1]))
    xh = torch.cat([history, x], dim=1)
    t = x.shape[1]
    out = sum(xh[:, i:i + t] * w[i] for i in range(CONV_WIDTH))
    return out + b, xh[:, -(CONV_WIDTH - 1):]


def _gates(params: dict, u: torch.Tensor):
    """RG-LRU gating: decay ``a`` and gated input from ``u: [..., W]``."""
    return rglru_gates(u, params["w_rg"], params["w_ig"], params["b_rg"],
                       params["b_ig"], params["lambda"])


def rglru_block_apply(params: dict, x: torch.Tensor,
                      state: RglruState | None = None,
                      use_kernel: bool = False):
    """Full-sequence recurrent block. ``x: [B, T, D]`` -> ``([B, T, D],
    state)``. ``use_kernel=True`` runs the recurrence through
    :func:`repro_torch.kernels.ops.rglru_scan` (the kernel on a CUDA
    device, which refuses operands autograd would record);
    ``use_kernel=False`` calls the plain, differentiable
    :func:`rglru_scan_batched_ref` on any device."""
    gate = gelu(x @ params["w_in_gate"])
    u = x @ params["w_in"]
    hist = state.conv if state is not None else None
    u, new_hist = _causal_conv(u, params["conv_w"], params["conv_b"], hist)
    a, gated = _gates(params, u)
    h0 = state.h if state is not None else None
    if x.shape[1] > 1 and assoc_route():
        scan = rglru_assoc_ref
    else:
        scan = ops.rglru_scan if use_kernel else rglru_scan_batched_ref
    hs, h_t = scan(gated, a, h0)
    y = (hs.to(x.dtype) * gate) @ params["w_out"]
    return y, RglruState(h=h_t, conv=new_hist)


def rglru_block_decode(params: dict, x: torch.Tensor, state: RglruState):
    """Single-step decode. ``x: [B, 1, D]``."""
    gate = gelu(x @ params["w_in_gate"])
    u = x @ params["w_in"]
    xh = torch.cat([state.conv, u], dim=1)              # [B, 4, W]
    u1 = sum(xh[:, i] * params["conv_w"][i] for i in range(CONV_WIDTH))
    u1 = (u1 + params["conv_b"])[:, None]               # [B, 1, W]
    a, gated = _gates(params, u1)
    h = (a[:, 0] * state.h
         + torch.sqrt(torch.clamp_min(1.0 - a[:, 0] ** 2, 0.0)) * gated[:, 0])
    y = (h[:, None].to(x.dtype) * gate) @ params["w_out"]
    return y, RglruState(h=h, conv=xh[:, 1:])


# ---------------------------------------------------------------------------
# Delta-capable decode entry points (EdgeDRNN Eq. 2/3 on the projections)
# ---------------------------------------------------------------------------

def init_rglru_delta_state(params: dict, batch_shape=()):
    """Per-layer delta-decode state for :func:`rglru_block_decode_delta`
    (it carries the conv history beside the Eq. 2/3 memories)."""
    from repro_torch.core.deltarglru import (init_deltarglru_state,
                                             rglru_layer_params)
    return init_deltarglru_state(rglru_layer_params(params), batch_shape)


def rglru_block_decode_delta(params: dict, x: torch.Tensor, state,
                             theta_x=0.0, theta_h=0.0,
                             backend: str = "dense"):
    """Delta-thresholded single-token block step, ``x: [B, D]``.

    ``backend="dense"`` is the reconstruction-form reference, bitwise
    :func:`rglru_block_decode` at ``theta_x == theta_h == 0``;
    ``backend="fused"`` runs the fired-block-compacting kernels. Returns a
    :class:`repro_torch.core.deltarglru.DeltaRglruStepOut`. For serving,
    compile the stack: ``compile_delta_program({"rglru": ...},
    cell="rglru")``.
    """
    from repro_torch.core.deltarglru import (deltarglru_step,
                                             rglru_layer_params)
    return deltarglru_step(rglru_layer_params(params), state, x, theta_x,
                           theta_h, backend=backend)

