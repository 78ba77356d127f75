"""Delta-RWKV6 — EdgeDRNN's delta trick on the RWKV6 time-mix projections,
the PyTorch port of :mod:`repro.core.deltarwkv`.

RWKV6 ("Finch") decode streams, per token and layer, the r/k/v projection
weights (``[D, D]`` each) and the decay-LoRA down-projection
(``[D, DECAY_LORA]``) for a batch-1 matvec. The mixed token-shift streams
feeding them are temporally smooth, so this module delta-encodes them and
skips the weight columns that did not fire:

* **Δx group** (``theta_x``): the mixed r/k/v streams, gating
  ``W_r / W_k / W_v`` — ``3·D²`` weights per layer.
* **Δh group** (``theta_h``): the mixed decay stream ``x_w``, gating
  ``decay_w1`` (``[D, DECAY_LORA]``).

Everything else stays dense: the token-shift LoRA, the gate and output
projections (``w_g`` / ``w_o``, driven by the live stream), the WKV
recurrence (:func:`repro_torch.kernels.ops.rwkv6_scan`) and the group norm.

Backends (registered under ``cell="rwkv6"``):

* ``"dense"`` — projections on the reconstructed held streams ``x̂``. At
  θ=0 the memory update ``where(fired, s, ŝ)`` makes ``x̂ ≡ s`` bit for
  bit, so a θ=0 delta step is bitwise the dense decode
  (:func:`repro_torch.models.rwkv.rwkv_time_mix` at T = 1): both call
  :func:`mix_streams` / :func:`group_norm_heads` from here and launch the
  same WKV kernel.
* ``"fused"`` — Eq. 3 accumulate form: per projection a delta memory
  ``M += Δx @ Wᵀ`` through the fired-block-compacting
  :func:`repro_torch.kernels.ops.delta_spmv` kernel, four launches and one
  WKV launch per layer step on a CUDA device.

Both emit per-layer ``(delta_x: [..., 3D], delta_h: [..., D])`` pairs, so
:class:`repro_torch.serve.engine.DeltaStreamEngine` accounts γ and weight
bytes with the same machinery as the GRU and LSTM programs. A sequence runs
as a Python loop over time; nothing in a step synchronises the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.backends import (BackendSpec, get_backend,
                                       register_backend)
from repro_torch.core.delta import DeltaState, delta_encode, init_delta_state
from repro_torch.core.thresholds import layer_theta
from repro_torch.kernels import ops

HEAD_DIM = 64
TSHIFT_LORA = 32
DECAY_LORA = 64

_BLOCK = 128  # delta_spmv block size the fused pack/step pair agrees on


class RwkvLayerParams(NamedTuple):
    """One RWKV6 time-mix layer (the tensors of
    :func:`repro_torch.models.rwkv.init_rwkv_time_mix`, as a compile-ready
    NamedTuple)."""

    mu_base: torch.Tensor     # [D]
    mu: torch.Tensor          # [5, D]        r,k,v,w,g lerp offsets
    tsh_w1: torch.Tensor      # [D, 5*TSHIFT_LORA]
    tsh_w2: torch.Tensor      # [5, TSHIFT_LORA, D]
    w_r: torch.Tensor         # [D, D]   delta-gated (Δx group)
    w_k: torch.Tensor         # [D, D]   delta-gated (Δx group)
    w_v: torch.Tensor         # [D, D]   delta-gated (Δx group)
    w_g: torch.Tensor         # [D, D]   dense
    w_o: torch.Tensor         # [D, D]   dense
    decay_base: torch.Tensor  # [D] f32
    decay_w1: torch.Tensor    # [D, DECAY_LORA]  delta-gated (Δh group)
    decay_w2: torch.Tensor    # [DECAY_LORA, D]  dense
    bonus_u: torch.Tensor     # [H, HEAD_DIM] f32
    ln_scale: torch.Tensor    # [D]

    @property
    def hidden_size(self) -> int:
        return self.w_o.shape[-1]

    @property
    def input_size(self) -> int:
        return self.w_r.shape[0]

    def to(self, device) -> "RwkvLayerParams":
        return RwkvLayerParams(*(t.to(device) for t in self))


def rwkv_layer_params(tm: dict) -> RwkvLayerParams:
    """Adapt a :func:`repro_torch.models.rwkv.init_rwkv_time_mix` dict."""
    return RwkvLayerParams(**{f: tm[f] for f in RwkvLayerParams._fields})


def rwkv_layer_dict(p: RwkvLayerParams) -> dict:
    """The inverse adapter (cell layer -> models-module params dict)."""
    return dict(zip(RwkvLayerParams._fields, p))


def init_deltarwkv_stack(generator: torch.Generator, d_model: int,
                         num_layers: int,
                         dtype=torch.float32) -> list[RwkvLayerParams]:
    """A stack of time-mix layers on the models-module init recipe, drawn
    on the CPU from ``generator``."""
    from repro_torch.models.rwkv import init_rwkv_time_mix
    return [rwkv_layer_params(init_rwkv_time_mix(generator, d_model, dtype))
            for _ in range(num_layers)]


def init_deltarwkv_model(generator, d_model: int, num_layers: int,
                         output_size: int, dtype=torch.float32,
                         device=None) -> dict:
    """``{"rwkv6": stack, "head", "head_b"}`` — the compile-ready model dict
    (:func:`repro_torch.core.program.compile_delta_program` carries the head
    into the program). ``generator`` is a ``torch.Generator`` or an int
    seed; the model is drawn on the CPU and moved to ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``). The numbers
    differ from the JAX package's for the same seed; use
    :func:`repro_torch.models.gru_rnn.model_from_numpy` to share weights."""
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.common import dense_init
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    stack = init_deltarwkv_stack(generator, d_model, num_layers, dtype)
    head = dense_init(generator, d_model, output_size, dtype)
    return {"rwkv6": [p.to(dev) for p in stack], "head": head.to(dev),
            "head_b": torch.zeros((output_size,), dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# Shared time-mix math (canonical expressions; models/rwkv.py imports these)
# ---------------------------------------------------------------------------

def mix_streams(x: torch.Tensor, xx: torch.Tensor, mu_base: torch.Tensor,
                mu: torch.Tensor, tsh_w1: torch.Tensor,
                tsh_w2: torch.Tensor) -> torch.Tensor:
    """RWKV6 data-dependent 5-way lerp. ``x, xx: [B, T, D]`` ->
    ``[5, B, T, D]`` (r, k, v, w, g mixed streams); ``xx`` is the token-shift
    difference ``x_{t-1} - x_t``. The dense delta backend and the full
    time-mix both call it, which makes θ=0 bitwise parity structural."""
    b, t, _ = x.shape
    x_base = x + xx * mu_base
    lora = torch.tanh(x_base @ tsh_w1).reshape(b, t, 5, TSHIFT_LORA)
    adj = torch.einsum("btfl,fld->fbtd", lora, tsh_w2)      # [5,B,T,D]
    return x[None] + xx[None] * (mu[:, None, None] + adj)


def group_norm_heads(y: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm over ``[B, T, H, D]`` -> scaled, flattened. The
    variance is the population variance, as ``jnp.var`` computes it."""
    b, t, h, d = y.shape
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return (yn.reshape(b, t, h * d) * scale).to(y.dtype)


# ---------------------------------------------------------------------------
# Delta layer state
# ---------------------------------------------------------------------------

class DeltaRwkvLayerState(NamedTuple):
    """Per-stream state of one delta-RWKV6 layer (every leaf leads with the
    stream axis)."""

    shift: torch.Tensor   # [..., D]  last raw input (token shift)
    wkv: torch.Tensor     # [..., H, HEAD_DIM, HEAD_DIM] f32 WKV state
    r_mem: DeltaState     # x̂_r [..., D]
    k_mem: DeltaState     # x̂_k [..., D]
    v_mem: DeltaState     # x̂_v [..., D]
    w_mem: DeltaState     # x̂_w [..., D]
    m_r: torch.Tensor     # [..., D]          fused Σ Δx_r @ W_rᵀ
    m_k: torch.Tensor     # [..., D]
    m_v: torch.Tensor     # [..., D]
    m_w: torch.Tensor     # [..., DECAY_LORA] fused Σ Δx_w @ decay_w1ᵀ


def init_deltarwkv_state(params: RwkvLayerParams, batch_shape=(),
                         dtype=None,
                         m_init: str = "zero") -> DeltaRwkvLayerState:
    """Zero state memories and delta memories (``x̂_0 = 0``, ``M_0 = 0``) on
    the device of the params. Both backends use ``m_init="zero"``: there is
    no bias to fold into the projection accumulators (``decay_base`` is
    applied at the activation stage), so the argument is accepted for
    registry uniformity and ignored."""
    del m_init
    dtype = dtype or params.w_r.dtype
    dev = params.w_r.device
    d = params.hidden_size
    h = d // HEAD_DIM

    def zeros(*shape, dt=dtype):
        return torch.zeros((*batch_shape, *shape), dtype=dt, device=dev)

    return DeltaRwkvLayerState(
        shift=zeros(d),
        wkv=zeros(h, HEAD_DIM, HEAD_DIM, dt=torch.float32),
        r_mem=init_delta_state((*batch_shape, d), dtype, dev),
        k_mem=init_delta_state((*batch_shape, d), dtype, dev),
        v_mem=init_delta_state((*batch_shape, d), dtype, dev),
        w_mem=init_delta_state((*batch_shape, d), dtype, dev),
        m_r=zeros(d), m_k=zeros(d), m_v=zeros(d), m_w=zeros(DECAY_LORA))


class DeltaRwkvStepOut(NamedTuple):
    h: torch.Tensor                 # layer output y [..., D]
    state: DeltaRwkvLayerState
    delta_x: torch.Tensor           # [..., 3D] concat(Δx_r, Δx_k, Δx_v)
    delta_h: torch.Tensor           # [..., D]  Δx_w (decay stream)


class RwkvFusedLayout(NamedTuple):
    """Pre-transposed, block-padded ``[O, I]`` spmv operands (pack once)."""

    wt_r: torch.Tensor      # [Dp, Dp]
    wt_k: torch.Tensor      # [Dp, Dp]
    wt_v: torch.Tensor      # [Dp, Dp]
    wt_decay: torch.Tensor  # [DECAY_LORAp, Dp]

    def to(self, device) -> "RwkvFusedLayout":
        return RwkvFusedLayout(*(t.to(device) for t in self))


def pack_rwkv_layer(p: RwkvLayerParams,
                    block: int = _BLOCK) -> RwkvFusedLayout:
    from repro_torch.kernels.delta_spmv import pack_spmv_weights

    def pk(w):
        return pack_spmv_weights(w.T, block_o=block, block_k=block)

    return RwkvFusedLayout(wt_r=pk(p.w_r), wt_k=pk(p.w_k), wt_v=pk(p.w_v),
                           wt_decay=pk(p.decay_w1))


# ---------------------------------------------------------------------------
# Layer step
# ---------------------------------------------------------------------------

def _layer_step(params: RwkvLayerParams, state: DeltaRwkvLayerState,
                x: torch.Tensor, theta_x, theta_h, *, accumulate: bool,
                layout: RwkvFusedLayout | None) -> DeltaRwkvStepOut:
    """One delta time-mix step. ``x: [..., D]`` (lead dims flattened).

    ``accumulate=False`` (dense): projections on the held streams ``x̂`` —
    bitwise the exact decode at θ=0. ``accumulate=True`` (fused): Eq. 3
    delta memories through :func:`repro_torch.kernels.ops.delta_spmv`.
    """
    d = params.hidden_size
    nh = d // HEAD_DIM
    lead = x.shape[:-1]
    xb = x.reshape(-1, d)
    b = xb.shape[0]

    def flat(a, w):
        return a.reshape(-1, w)

    shift = flat(state.shift, d)
    x3 = xb[:, None, :]                          # [B, 1, D]
    xx = shift[:, None, :] - x3                  # token shift: x_{t-1} - x_t
    x_r, x_k, x_v, x_w, x_g = mix_streams(x3, xx, params.mu_base, params.mu,
                                          params.tsh_w1, params.tsh_w2)

    # Eq. 2 on the projection input streams.
    enc_r = delta_encode(x_r[:, 0], DeltaState(flat(state.r_mem.memory, d)),
                         theta_x)
    enc_k = delta_encode(x_k[:, 0], DeltaState(flat(state.k_mem.memory, d)),
                         theta_x)
    enc_v = delta_encode(x_v[:, 0], DeltaState(flat(state.v_mem.memory, d)),
                         theta_x)
    enc_w = delta_encode(x_w[:, 0], DeltaState(flat(state.w_mem.memory, d)),
                         theta_h)

    if accumulate:
        lay = layout if layout is not None else pack_rwkv_layer(params)

        def spmv(wt, dx, acc, o):
            return ops.delta_spmv(wt, dx, acc, block_k=_BLOCK, packed=True,
                                  out_dim=o)

        m_r = spmv(lay.wt_r, enc_r.delta, flat(state.m_r, d), d)
        m_k = spmv(lay.wt_k, enc_k.delta, flat(state.m_k, d), d)
        m_v = spmv(lay.wt_v, enc_v.delta, flat(state.m_v, d), d)
        m_w = spmv(lay.wt_decay, enc_w.delta, flat(state.m_w, DECAY_LORA),
                   DECAY_LORA)
        r_flat, k_flat, v_flat = m_r, m_k, m_v   # ≡ x̂ @ W (exact arithmetic)
        pre_w = m_w[:, None]                     # [B, 1, DECAY_LORA]
    else:
        # Reconstruction form: x̂ @ W on the held streams. At θ=0 the held
        # stream IS the raw stream (bitwise), so this is the exact decode.
        r_flat = (enc_r.state.memory[:, None] @ params.w_r)[:, 0]
        k_flat = (enc_k.state.memory[:, None] @ params.w_k)[:, 0]
        v_flat = (enc_v.state.memory[:, None] @ params.w_v)[:, 0]
        pre_w = enc_w.state.memory[:, None] @ params.decay_w1
        m_r, m_k, m_v = (flat(state.m_r, d), flat(state.m_k, d),
                         flat(state.m_v, d))
        m_w = flat(state.m_w, DECAY_LORA)

    r = r_flat.reshape(b, 1, nh, HEAD_DIM)
    k = k_flat.reshape(b, 1, nh, HEAD_DIM)
    v = v_flat.reshape(b, 1, nh, HEAD_DIM)
    g = torch.nn.functional.silu(x_g @ params.w_g)   # dense, live stream

    decay_log = params.decay_base + torch.tanh(pre_w) @ params.decay_w2
    w = torch.exp(-torch.exp(decay_log.to(torch.float32)))
    w = w.reshape(b, 1, nh, HEAD_DIM)

    def tr(z):                                   # [B,1,H,Dh] -> [B,H,1,Dh]
        return torch.movedim(z, 2, 1)

    wkv0 = state.wkv.reshape(-1, nh, HEAD_DIM, HEAD_DIM)
    y, wkv_t = ops.rwkv6_scan(tr(r), tr(k), tr(v), tr(w), params.bonus_u,
                              wkv0)
    y = torch.movedim(y, 1, 2)                   # [B,1,H,Dh]
    y = group_norm_heads(y.to(torch.float32),
                         params.ln_scale.to(torch.float32))
    y = (y.to(x.dtype) * g) @ params.w_o         # [B, 1, D]

    def unflat(a):
        return a.reshape(*lead, *a.shape[1:])

    new_state = DeltaRwkvLayerState(
        shift=unflat(xb),
        wkv=unflat(wkv_t),
        r_mem=DeltaState(unflat(enc_r.state.memory)),
        k_mem=DeltaState(unflat(enc_k.state.memory)),
        v_mem=DeltaState(unflat(enc_v.state.memory)),
        w_mem=DeltaState(unflat(enc_w.state.memory)),
        m_r=unflat(m_r), m_k=unflat(m_k), m_v=unflat(m_v), m_w=unflat(m_w))
    delta_x = torch.cat([enc_r.delta, enc_k.delta, enc_v.delta], dim=-1)
    return DeltaRwkvStepOut(h=unflat(y[:, 0]), state=new_state,
                            delta_x=unflat(delta_x),
                            delta_h=unflat(enc_w.delta))


# -- per-backend step implementations (registered BackendSpec.step fns) -----

def _step_dense(params, state, x, theta_x, theta_h, *, layout):
    return _layer_step(params, state, x, theta_x, theta_h, accumulate=False,
                       layout=None)


def _step_fused(params, state, x, theta_x, theta_h, *, layout):
    return _layer_step(params, state, x, theta_x, theta_h, accumulate=True,
                       layout=layout)


def _pack_none(params, block):
    return params, None


def _pack_fused(params, block):
    # A fixed _BLOCK pad whatever block is asked for: the step always issues
    # delta_spmv at _BLOCK, and pack and step must agree.
    del block
    return params, [pack_rwkv_layer(p) for p in params]


register_backend(BackendSpec(
    name="dense", cell="rwkv6", pack=_pack_none, step=_step_dense,
    m_init="zero", weight_bits=32))
register_backend(BackendSpec(
    name="fused", cell="rwkv6", pack=_pack_fused, step=_step_fused,
    m_init="zero", weight_bits=32))


def deltarwkv_step(params: RwkvLayerParams, state: DeltaRwkvLayerState,
                   x: torch.Tensor, theta_x, theta_h, backend: str = "dense",
                   layout=None) -> DeltaRwkvStepOut:
    """One delta time-mix layer timestep through the ``cell="rwkv6"``
    registry; ``layout`` is the pre-packed layer (packed on the fly
    otherwise)."""
    spec = get_backend(backend, cell="rwkv6")
    return spec.step(params, state, x, theta_x, theta_h, layout=layout)


# ---------------------------------------------------------------------------
# Multi-layer stacks over sequences
# ---------------------------------------------------------------------------

class DeltaRwkvStackState(NamedTuple):
    layers: tuple  # tuple[DeltaRwkvLayerState, ...]


def init_deltarwkv_stack_state(params: Sequence[RwkvLayerParams],
                               batch_shape=(), dtype=None,
                               m_init: str = "zero") -> DeltaRwkvStackState:
    return DeltaRwkvStackState(
        layers=tuple(init_deltarwkv_state(p, batch_shape, dtype,
                                          m_init=m_init) for p in params))


def deltarwkv_stack_step(params: Sequence[RwkvLayerParams],
                         state: DeltaRwkvStackState, x: torch.Tensor,
                         theta_x, theta_h, backend: str = "dense",
                         layouts=None):
    """One timestep through all layers (layer l+1 consumes layer l's y).
    Returns ``(y, new_stack_state, [(delta_x, delta_h), ...])``."""
    new_layers = []
    deltas = []
    inp = x
    for li, (p, st) in enumerate(zip(params, state.layers)):
        out = deltarwkv_step(
            p, st, inp, layer_theta(theta_x, li), layer_theta(theta_h, li),
            backend=backend,
            layout=layouts[li] if layouts is not None else None)
        new_layers.append(out.state)
        deltas.append((out.delta_x, out.delta_h))
        inp = out.h
    return inp, DeltaRwkvStackState(tuple(new_layers)), deltas


def run_sequence(stack_step, init_stack_state, cell: str, params, xs,
                 theta_x, theta_h, init_state, collect_sparsity: bool,
                 backend: str, layouts):
    """The sequence loop the LM cells share: pack once, loop over
    ``xs: [T, B, D]`` and collect the firing fractions. Returns ``(ys
    [T, B, D], final_state, stats)`` with the ``{"gamma_dx", "gamma_dh",
    "per_layer"}`` stats contract of the GRU and LSTM sequences."""
    spec = get_backend(backend, cell=cell)
    if init_state is None:
        init_state = init_stack_state(params, xs.shape[1:-1], xs.dtype,
                                      m_init=spec.m_init)
    if layouts is None:
        _, layouts = spec.pack(list(params), _BLOCK)
    state = init_state
    ys = []
    per_layer = [([], []) for _ in params]
    for x in xs:
        y, state, deltas = stack_step(params, state, x, theta_x, theta_h,
                                      backend=backend, layouts=layouts)
        ys.append(y)
        if collect_sparsity:
            for (gx, gh), (dx, dh) in zip(per_layer, deltas):
                gx.append(torch.mean((dx == 0).to(torch.float32)))
                gh.append(torch.mean((dh == 0).to(torch.float32)))
    ys = torch.stack(ys)
    if not collect_sparsity:
        return ys, state, {}
    stats = tuple((torch.stack(gx), torch.stack(gh)) for gx, gh in per_layer)
    gamma_dx = torch.mean(torch.stack([torch.mean(s[0]) for s in stats]))
    gamma_dh = torch.mean(torch.stack([torch.mean(s[1]) for s in stats]))
    return ys, state, {"gamma_dx": gamma_dx, "gamma_dh": gamma_dh,
                       "per_layer": stats}


def deltarwkv_sequence(params: Sequence[RwkvLayerParams], xs: torch.Tensor,
                       theta_x, theta_h,
                       init_state: DeltaRwkvStackState | None = None,
                       collect_sparsity: bool = True,
                       backend: str = "dense", layouts=None):
    """Run a delta-RWKV6 stack over ``xs: [T, B, D]`` (a Python loop over
    T); returns ``(ys, final_state, stats)``."""
    return run_sequence(deltarwkv_stack_step, init_deltarwkv_stack_state,
                        "rwkv6", params, xs, theta_x, theta_h, init_state,
                        collect_sparsity, backend, layouts)
