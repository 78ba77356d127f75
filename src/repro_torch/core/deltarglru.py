"""Delta-RG-LRU — EdgeDRNN's delta trick on the Griffin recurrent block, the
PyTorch port of :mod:`repro.core.deltarglru`.

RecurrentGemma's recurrent block decodes, per token and layer, with the
block-input projections (``w_in`` + ``w_in_gate``, ``[D, W]`` each) and
the gate projections (``w_rg`` + ``w_ig``, ``[W, W]`` each) as batch-1
matvecs. Two temporally smooth streams gate them:

* **Δx group** (``theta_x``): the layer input ``x_t``, gating ``w_in`` /
  ``w_in_gate`` — ``2·D·W`` weights per layer.
* **Δh group** (``theta_h``): the post-conv stream ``u_t`` feeding the
  recurrence and input gates, gating ``w_rg`` / ``w_ig`` — ``2·W²`` per
  layer. The causal conv (width 4) runs densely on the held recurrent-
  branch projection, with its 3-step history carried in the layer state.

Dense side: the conv, ``λ``, the biases, the recurrence
(:func:`repro_torch.kernels.ops.rglru_scan` at T = 1 in ``fused``), the
``i·u`` input gating (live stream) and ``w_out``.

Backends (registered under ``cell="rglru"``):

* ``"dense"`` — projections on the held streams ``x̂`` / ``û``; at θ=0 a
  step is bitwise :func:`repro_torch.models.rglru.rglru_block_decode`
  (both call :func:`rglru_gates`, and the recurrence is spelled here as the
  decode spells it, not through the scan kernel).
* ``"fused"`` — Eq. 3 delta memories ``M += Δ @ Wᵀ`` per projection through
  :func:`repro_torch.kernels.ops.delta_spmv` (biases at the activation
  stage), four launches and one scan launch per layer step on a CUDA
  device.

Two spellings differ from the JAX package's defaults on purpose:
``jax.nn.gelu`` is the tanh approximation, so ``gelu`` here passes
``approximate="tanh"``; ``jax.nn.softplus`` is ``logaddexp(x, 0)`` while
``torch.nn.functional.softplus`` returns ``x`` itself above 20 — λ lies
near -4 to -9 here, where both compute ``log1p(exp(x))``, so the switch
never reaches the recurrence.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.backends import (BackendSpec, get_backend,
                                       register_backend)
from repro_torch.core.delta import DeltaState, delta_encode, init_delta_state
from repro_torch.core.deltarwkv import run_sequence
from repro_torch.core.thresholds import layer_theta
from repro_torch.kernels import ops

_C = 8.0  # Griffin's fixed exponent scale
CONV_WIDTH = 4

_BLOCK = 128  # delta_spmv block size the fused pack/step pair agrees on


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class RglruLayerParams(NamedTuple):
    """One RG-LRU block (the tensors of
    :func:`repro_torch.models.rglru.init_rglru_block`, as a compile-ready
    NamedTuple; the dict's ``"lambda"`` key is the ``lam`` field)."""

    w_in: torch.Tensor       # [D, W]  delta-gated (Δx group)
    w_in_gate: torch.Tensor  # [D, W]  delta-gated (Δx group)
    conv_w: torch.Tensor     # [CONV_WIDTH, W]  dense
    conv_b: torch.Tensor     # [W]
    w_rg: torch.Tensor       # [W, W]  delta-gated (Δh group)
    w_ig: torch.Tensor       # [W, W]  delta-gated (Δh group)
    b_rg: torch.Tensor       # [W]
    b_ig: torch.Tensor       # [W]
    lam: torch.Tensor        # [W] f32
    w_out: torch.Tensor      # [W, D]  dense

    @property
    def hidden_size(self) -> int:
        return self.w_rg.shape[0]   # W (lru width)

    @property
    def input_size(self) -> int:
        return self.w_in.shape[0]   # D (d_model)

    def to(self, device) -> "RglruLayerParams":
        return RglruLayerParams(*(t.to(device) for t in self))


def rglru_layer_params(block: dict) -> RglruLayerParams:
    """Adapt a :func:`repro_torch.models.rglru.init_rglru_block` dict."""
    return RglruLayerParams(**{f: block["lambda" if f == "lam" else f]
                               for f in RglruLayerParams._fields})


def rglru_layer_dict(p: RglruLayerParams) -> dict:
    """The inverse adapter (cell layer -> models-module params dict)."""
    return {("lambda" if f == "lam" else f): t
            for f, t in zip(RglruLayerParams._fields, p)}


def init_deltarglru_stack(generator: torch.Generator, d_model: int,
                          num_layers: int, lru_width: int | None = None,
                          dtype=torch.float32) -> list[RglruLayerParams]:
    """A stack of RG-LRU blocks on the models-module init recipe (each maps
    D -> D; the LRU width is internal), drawn on the CPU."""
    from repro_torch.models.rglru import init_rglru_block
    return [rglru_layer_params(init_rglru_block(generator, d_model,
                                                lru_width, dtype))
            for _ in range(num_layers)]


def init_deltarglru_model(generator, d_model: int, num_layers: int,
                          output_size: int, lru_width: int | None = None,
                          dtype=torch.float32, device=None) -> dict:
    """``{"rglru": stack, "head", "head_b"}`` — the compile-ready model
    dict; same generator and device rules as
    :func:`repro_torch.core.deltarwkv.init_deltarwkv_model`."""
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.common import dense_init
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    stack = init_deltarglru_stack(generator, d_model, num_layers, lru_width,
                                  dtype)
    head = dense_init(generator, d_model, output_size, dtype)
    return {"rglru": [p.to(dev) for p in stack], "head": head.to(dev),
            "head_b": torch.zeros((output_size,), dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# Shared gate math (canonical expressions; models/rglru.py imports this)
# ---------------------------------------------------------------------------

def rglru_gates(u: torch.Tensor, w_rg: torch.Tensor, w_ig: torch.Tensor,
                b_rg: torch.Tensor, b_ig: torch.Tensor, lam: torch.Tensor):
    """RG-LRU gating from ``u: [..., W]``: the decay ``a`` and the gated
    input. The dense delta backend and the block decode both call it."""
    r = torch.sigmoid(u @ w_rg + b_rg).to(torch.float32)
    i = torch.sigmoid(u @ w_ig + b_ig).to(torch.float32)
    log_a = -_C * F.softplus(lam) * r        # [..., W] (< 0)
    a = torch.exp(log_a)
    return a, i * u.to(torch.float32)


# ---------------------------------------------------------------------------
# Delta layer state
# ---------------------------------------------------------------------------

class DeltaRglruLayerState(NamedTuple):
    """Per-stream state of one delta-RG-LRU layer (every leaf leads with the
    stream axis)."""

    h: torch.Tensor       # [..., W] f32 recurrent state
    conv: torch.Tensor    # [..., CONV_WIDTH-1, W] conv history
    x_mem: DeltaState     # x̂ [..., D]  (layer input stream)
    u_mem: DeltaState     # û [..., W]  (post-conv gate stream)
    m_in: torch.Tensor    # [..., W]  fused Σ Δx @ w_inᵀ
    m_gate: torch.Tensor  # [..., W]  fused Σ Δx @ w_in_gateᵀ
    m_rg: torch.Tensor    # [..., W]  fused Σ Δu @ w_rgᵀ
    m_ig: torch.Tensor    # [..., W]  fused Σ Δu @ w_igᵀ


def init_deltarglru_state(params: RglruLayerParams, batch_shape=(),
                          dtype=None,
                          m_init: str = "zero") -> DeltaRglruLayerState:
    """Zero state memories, delta memories and conv history on the device
    of the params (both backends use ``m_init="zero"``: the biases apply at
    the activation stage; the argument is accepted for uniformity)."""
    del m_init
    dtype = dtype or params.w_in.dtype
    dev = params.w_in.device
    d, w = params.input_size, params.hidden_size

    def zeros(*shape, dt=dtype):
        return torch.zeros((*batch_shape, *shape), dtype=dt, device=dev)

    return DeltaRglruLayerState(
        h=zeros(w, dt=torch.float32),
        conv=zeros(CONV_WIDTH - 1, w),
        x_mem=init_delta_state((*batch_shape, d), dtype, dev),
        u_mem=init_delta_state((*batch_shape, w), dtype, dev),
        m_in=zeros(w), m_gate=zeros(w), m_rg=zeros(w), m_ig=zeros(w))


class DeltaRglruStepOut(NamedTuple):
    h: torch.Tensor                  # layer output y [..., D]
    state: DeltaRglruLayerState
    delta_x: torch.Tensor            # [..., D] Δx (input stream)
    delta_h: torch.Tensor            # [..., W] Δu (post-conv gate stream)


class RglruFusedLayout(NamedTuple):
    """Pre-transposed, block-padded ``[O, I]`` spmv operands."""

    wt_in: torch.Tensor       # [Wp, Dp]
    wt_in_gate: torch.Tensor  # [Wp, Dp]
    wt_rg: torch.Tensor       # [Wp, Wp]
    wt_ig: torch.Tensor       # [Wp, Wp]

    def to(self, device) -> "RglruFusedLayout":
        return RglruFusedLayout(*(t.to(device) for t in self))


def pack_rglru_layer(p: RglruLayerParams,
                     block: int = _BLOCK) -> RglruFusedLayout:
    from repro_torch.kernels.delta_spmv import pack_spmv_weights

    def pk(w):
        return pack_spmv_weights(w.T, block_o=block, block_k=block)

    return RglruFusedLayout(wt_in=pk(p.w_in), wt_in_gate=pk(p.w_in_gate),
                            wt_rg=pk(p.w_rg), wt_ig=pk(p.w_ig))


# ---------------------------------------------------------------------------
# Layer step
# ---------------------------------------------------------------------------

def _layer_step(params: RglruLayerParams, state: DeltaRglruLayerState,
                x: torch.Tensor, theta_x, theta_h, *, accumulate: bool,
                layout: RglruFusedLayout | None) -> DeltaRglruStepOut:
    """One delta RG-LRU step. ``x: [..., D]`` (lead dims flattened)."""
    d, w = params.input_size, params.hidden_size
    lead = x.shape[:-1]
    xb = x.reshape(-1, d)

    def flat(a, n):
        return a.reshape(-1, n)

    enc_x = delta_encode(xb, DeltaState(flat(state.x_mem.memory, d)),
                         theta_x)

    if accumulate:
        lay = layout if layout is not None else pack_rglru_layer(params)

        def spmv(wt, dx, acc):
            return ops.delta_spmv(wt, dx, acc, block_k=_BLOCK, packed=True,
                                  out_dim=w)

        m_in = spmv(lay.wt_in, enc_x.delta, flat(state.m_in, w))
        m_gate = spmv(lay.wt_in_gate, enc_x.delta, flat(state.m_gate, w))
        u_proj = m_in                              # ≡ x̂ @ w_in (exact arith)
        gate = gelu(m_gate[:, None])               # [B, 1, W]
    else:
        x_held = enc_x.state.memory[:, None]       # [B, 1, D]
        gate = gelu(x_held @ params.w_in_gate)
        u_proj = (x_held @ params.w_in)[:, 0]      # [B, W]
        m_in, m_gate = flat(state.m_in, w), flat(state.m_gate, w)

    # Dense causal conv on the held / accumulated recurrent-branch stream;
    # the 3-step history rides in the layer state.
    xh = torch.cat([flat(state.conv, w).reshape(-1, CONV_WIDTH - 1, w),
                    u_proj[:, None]], dim=1)                  # [B, 4, W]
    u1 = sum(xh[:, i] * params.conv_w[i] for i in range(CONV_WIDTH))
    u1 = u1 + params.conv_b                                   # [B, W]

    enc_u = delta_encode(u1, DeltaState(flat(state.u_mem.memory, w)),
                         theta_h)

    if accumulate:
        m_rg = spmv(lay.wt_rg, enc_u.delta, flat(state.m_rg, w))
        m_ig = spmv(lay.wt_ig, enc_u.delta, flat(state.m_ig, w))
        r = torch.sigmoid(m_rg + params.b_rg).to(torch.float32)[:, None]
        i = torch.sigmoid(m_ig + params.b_ig).to(torch.float32)[:, None]
        a = torch.exp(-_C * F.softplus(params.lam) * r)       # [B, 1, W]
        # The input gating multiplies the LIVE stream (no weight fetch).
        gated = i * u1.to(torch.float32)[:, None]
        # The recurrence through the scan kernel (T = 1).
        hs, h_t = ops.rglru_scan(gated, a, flat(state.h, w))
    else:
        u_held = enc_u.state.memory[:, None]                  # [B, 1, W]
        a, _ = rglru_gates(u_held, params.w_rg, params.w_ig, params.b_rg,
                           params.b_ig, params.lam)
        i = torch.sigmoid(u_held @ params.w_ig
                          + params.b_ig).to(torch.float32)
        gated = i * u1.to(torch.float32)[:, None]
        m_rg, m_ig = flat(state.m_rg, w), flat(state.m_ig, w)
        # The bitwise reference: the recurrence spelled exactly as
        # rglru_block_decode spells it.
        h_t = (a[:, 0] * flat(state.h, w)
               + torch.sqrt(torch.clamp_min(1.0 - a[:, 0] ** 2, 0.0))
               * gated[:, 0])
        hs = h_t[:, None]
    y = (hs.to(x.dtype) * gate) @ params.w_out                # [B, 1, D]

    def unflat(a_):
        return a_.reshape(*lead, *a_.shape[1:])

    new_state = DeltaRglruLayerState(
        h=unflat(h_t),
        conv=unflat(xh[:, 1:]),
        x_mem=DeltaState(unflat(enc_x.state.memory)),
        u_mem=DeltaState(unflat(enc_u.state.memory)),
        m_in=unflat(m_in), m_gate=unflat(m_gate),
        m_rg=unflat(m_rg), m_ig=unflat(m_ig))
    return DeltaRglruStepOut(h=unflat(y[:, 0]), state=new_state,
                             delta_x=unflat(enc_x.delta),
                             delta_h=unflat(enc_u.delta))


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
    # A fixed _BLOCK pad whatever block is asked for (pack and step agree).
    del block
    return params, [pack_rglru_layer(p) for p in params]


register_backend(BackendSpec(
    name="dense", cell="rglru", pack=_pack_none, step=_step_dense,
    m_init="zero", weight_bits=32))
register_backend(BackendSpec(
    name="fused", cell="rglru", pack=_pack_fused, step=_step_fused,
    m_init="zero", weight_bits=32))


def deltarglru_step(params: RglruLayerParams, state: DeltaRglruLayerState,
                    x: torch.Tensor, theta_x, theta_h,
                    backend: str = "dense",
                    layout=None) -> DeltaRglruStepOut:
    """One delta RG-LRU layer timestep through the ``cell="rglru"``
    registry."""
    spec = get_backend(backend, cell="rglru")
    return spec.step(params, state, x, theta_x, theta_h, layout=layout)


# ---------------------------------------------------------------------------
# Multi-layer stacks over sequences
# ---------------------------------------------------------------------------

class DeltaRglruStackState(NamedTuple):
    layers: tuple  # tuple[DeltaRglruLayerState, ...]


def init_deltarglru_stack_state(params: Sequence[RglruLayerParams],
                                batch_shape=(), dtype=None,
                                m_init: str = "zero") -> DeltaRglruStackState:
    return DeltaRglruStackState(
        layers=tuple(init_deltarglru_state(p, batch_shape, dtype,
                                           m_init=m_init) for p in params))


def deltarglru_stack_step(params: Sequence[RglruLayerParams],
                          state: DeltaRglruStackState, x: torch.Tensor,
                          theta_x, theta_h, backend: str = "dense",
                          layouts=None):
    """One timestep through all layers (each block maps D -> D). Returns
    ``(y, new_stack_state, [(delta_x, delta_h), ...])``."""
    new_layers = []
    deltas = []
    inp = x
    for li, (p, st) in enumerate(zip(params, state.layers)):
        out = deltarglru_step(
            p, st, inp, layer_theta(theta_x, li), layer_theta(theta_h, li),
            backend=backend,
            layout=layouts[li] if layouts is not None else None)
        new_layers.append(out.state)
        deltas.append((out.delta_x, out.delta_h))
        inp = out.h
    return inp, DeltaRglruStackState(tuple(new_layers)), deltas


def deltarglru_sequence(params: Sequence[RglruLayerParams], xs: torch.Tensor,
                        theta_x, theta_h,
                        init_state: DeltaRglruStackState | None = None,
                        collect_sparsity: bool = True,
                        backend: str = "dense", layouts=None):
    """Run a delta-RG-LRU stack over ``xs: [T, B, D]`` (a Python loop over
    T); returns ``(ys, final_state, stats)``."""
    return run_sequence(deltarglru_stack_step, init_deltarglru_stack_state,
                        "rglru", params, xs, theta_x, theta_h, init_state,
                        collect_sparsity, backend, layouts)
