"""RWKV-6 ("Finch") blocks: time-mix with data-dependent decay and
channel-mix, the PyTorch port of :mod:`repro.models.rwkv`.

RWKV is attention-free: decode carries an O(D²/head) state instead of a KV
cache. The WKV recurrence runs through
:func:`repro_torch.kernels.ops.rwkv6_scan` (the CUDA kernel on a CUDA
device, its plain version on the CPU) when :func:`rwkv_time_mix` is asked
for the kernel, and through the plain version
:func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan_batched_ref`, by name,
otherwise (the default, as the reference's ``use_kernel=False``): the
kernel has no backward, so a differentiated call takes the plain scan.
Callers who want the chunk-parallel form call
:func:`repro_torch.kernels.ops.rwkv6_chunked` themselves.

The time-mix expressions live in :mod:`repro_torch.core.deltarwkv`, so the
delta decode and this path share one set of ops: that is what makes the
θ=0 delta decode bitwise equal to :func:`rwkv_time_mix` at T = 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.deltarwkv import (DECAY_LORA, HEAD_DIM, TSHIFT_LORA,
                                        group_norm_heads, mix_streams)
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_batched_ref
from repro_torch.models.common import dense_init


def init_rwkv_time_mix(generator: torch.Generator, d_model: int,
                       dtype=torch.float32) -> dict:
    """One time-mix layer drawn from ``generator`` on its device (the JAX
    recipe: zero lerp offsets, truncated-normal fan-in projections, decay
    base -6, bonus ``u ~ 0.1 N(0, 1)``, unit group-norm scale)."""
    h = d_model // HEAD_DIM
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev)

    return {
        "mu_base": torch.zeros((d_model,), dtype=dtype, device=dev),
        # r, k, v, w, g
        "mu": torch.zeros((5, d_model), dtype=dtype, device=dev),
        "tsh_w1": dense_init(generator, d_model, 5 * TSHIFT_LORA, dtype),
        "tsh_w2": (normal(5, TSHIFT_LORA, d_model)
                   * TSHIFT_LORA ** -0.5).to(dtype),
        "w_r": dense_init(generator, d_model, d_model, dtype),
        "w_k": dense_init(generator, d_model, d_model, dtype),
        "w_v": dense_init(generator, d_model, d_model, dtype),
        "w_g": dense_init(generator, d_model, d_model, dtype),
        "w_o": dense_init(generator, d_model, d_model, dtype),
        "decay_base": torch.full((d_model,), -6.0, dtype=torch.float32,
                                 device=dev),
        "decay_w1": dense_init(generator, d_model, DECAY_LORA, dtype),
        "decay_w2": dense_init(generator, DECAY_LORA, d_model, dtype),
        "bonus_u": normal(h, HEAD_DIM) * 0.1,
        # group norm
        "ln_scale": torch.ones((d_model,), dtype=dtype, device=dev),
    }


def init_rwkv_channel_mix(generator: torch.Generator, d_model: int,
                          d_ff: int, dtype=torch.float32) -> dict:
    dev = generator.device
    return {
        "mu_k": torch.zeros((d_model,), dtype=dtype, device=dev),
        "mu_r": torch.zeros((d_model,), dtype=dtype, device=dev),
        "w_k": dense_init(generator, d_model, d_ff, dtype),
        "w_v": dense_init(generator, d_ff, d_model, dtype),
        "w_r": dense_init(generator, d_model, d_model, dtype),
    }


class RwkvState(NamedTuple):
    tm_shift: torch.Tensor   # [B, D] last input to time-mix
    cm_shift: torch.Tensor   # [B, D] last input to channel-mix
    wkv: torch.Tensor        # [B, H, HEAD_DIM, HEAD_DIM]


def init_rwkv_state(batch: int, d_model: int, dtype=torch.float32,
                    device=None) -> RwkvState:
    h = d_model // HEAD_DIM
    return RwkvState(
        tm_shift=torch.zeros((batch, d_model), dtype=dtype, device=device),
        cm_shift=torch.zeros((batch, d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                        device=device))


def _token_shift(x: torch.Tensor, last: torch.Tensor):
    """``shift(x)_t = x_{t-1}`` with ``last`` filling t = 0. Returns
    ``(xx, new_last)``."""
    prev = torch.cat([last[:, None], x[:, :-1]], dim=1)
    return prev - x, x[:, -1]


def rwkv_time_mix(params: dict, x: torch.Tensor, state: RwkvState,
                  use_kernel: bool = False):
    """``x: [B, T, D]`` -> ``(y, new_tm_shift, new_wkv_state)``.

    ``use_kernel=True`` runs the WKV recurrence through
    :func:`repro_torch.kernels.ops.rwkv6_scan` (the kernel on a CUDA
    device, which refuses operands autograd would record);
    ``use_kernel=False`` calls the plain, differentiable
    :func:`rwkv6_scan_batched_ref` on any device."""
    b, t, d = x.shape
    h = d // HEAD_DIM
    xx, new_last = _token_shift(x, state.tm_shift)

    # data-dependent lerp (fused 5-way LoRA)
    x_r, x_k, x_v, x_w, x_g = mix_streams(x, xx, params["mu_base"],
                                          params["mu"], params["tsh_w1"],
                                          params["tsh_w2"])

    r = (x_r @ params["w_r"]).reshape(b, t, h, HEAD_DIM)
    k = (x_k @ params["w_k"]).reshape(b, t, h, HEAD_DIM)
    v = (x_v @ params["w_v"]).reshape(b, t, h, HEAD_DIM)
    g = F.silu(x_g @ params["w_g"])

    decay_log = (params["decay_base"]
                 + torch.tanh(x_w @ params["decay_w1"]) @ params["decay_w2"])
    w = torch.exp(-torch.exp(decay_log.to(torch.float32)))         # (0,1)
    w = w.reshape(b, t, h, HEAD_DIM)

    def tr(z):                      # [B, T, H, D] -> [B, H, T, D]
        return torch.movedim(z, 2, 1)

    scan = ops.rwkv6_scan if use_kernel else rwkv6_scan_batched_ref
    y, wkv_t = scan(tr(r), tr(k), tr(v), tr(w), params["bonus_u"], state.wkv)
    y = torch.movedim(y, 1, 2)                                      # [B,T,H,D]
    y = group_norm_heads(y.to(torch.float32),
                         params["ln_scale"].to(torch.float32))
    y = (y.to(x.dtype) * g) @ params["w_o"]
    return y, new_last, wkv_t


# ---------------------------------------------------------------------------
# Delta-capable decode entry points (EdgeDRNN Eq. 2/3 on the projections)
# ---------------------------------------------------------------------------

def init_rwkv_delta_state(params: dict, batch_shape=()):
    """Per-layer delta-decode state for :func:`rwkv_time_mix_delta`."""
    from repro_torch.core.deltarwkv import (init_deltarwkv_state,
                                            rwkv_layer_params)
    return init_deltarwkv_state(rwkv_layer_params(params), batch_shape)


def rwkv_time_mix_delta(params: dict, x: torch.Tensor, state, theta_x=0.0,
                        theta_h=0.0, backend: str = "dense"):
    """Delta-thresholded single-token time-mix step, ``x: [B, D]``.

    ``backend="dense"`` is the reconstruction-form reference, bitwise the
    one-token :func:`rwkv_time_mix` at ``theta_x == theta_h == 0``;
    ``backend="fused"`` runs the fired-block-compacting kernels. Returns a
    :class:`repro_torch.core.deltarwkv.DeltaRwkvStepOut`. For serving,
    compile the stack: ``compile_delta_program({"rwkv6": ...},
    cell="rwkv6")``.
    """
    from repro_torch.core.deltarwkv import deltarwkv_step, rwkv_layer_params
    return deltarwkv_step(rwkv_layer_params(params), state, x, theta_x,
                          theta_h, backend=backend)


def rwkv_channel_mix(params: dict, x: torch.Tensor, last: torch.Tensor):
    """``x: [B, T, D]`` -> ``(y, new_cm_shift)``."""
    xx, new_last = _token_shift(x, last)
    x_k = x + xx * params["mu_k"]
    x_r = x + xx * params["mu_r"]
    k = torch.square(F.relu(x_k @ params["w_k"]))
    r = torch.sigmoid(x_r @ params["w_r"])
    return r * (k @ params["w_v"]), new_last
