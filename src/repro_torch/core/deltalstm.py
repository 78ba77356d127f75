"""DeltaLSTM — the delta-network algorithm on LSTM cells, the PyTorch port of
:mod:`repro.core.deltalstm`.

Gate order ``i`` (input), ``f`` (forget), ``g`` (candidate), ``o``
(output); ``W_x: [4H, I]``, ``W_h: [4H, H]``. The delta memories hold one
running pre-activation per gate, ``M = M_prev + W_x dx + W_h dh``: the same
bookkeeping as DeltaGRU with four gates, no split candidate, and a cell
state ``c``.

Backends (registered under ``cell="lstm"`` in
:mod:`repro_torch.core.backends`), the same seven as the GRU's:

* ``"dense"`` — plain matmuls; zeros in the deltas are multiplied. The
  one backend that takes custom ``sigmoid=`` / ``tanh=``; the kernel
  backends below raise on them.
* ``"fused"`` — one launch of the fp32 LSTM layer-step kernel per layer
  step (:mod:`repro_torch.kernels.deltalstm_seq`).
* ``"fused_q8"`` / ``"fused_q4"`` — the fixed-point pipeline (int8 or
  nibble-packed int4 codes, Q8.8 activations, code-domain delta memories,
  Q1.4 LUT gates, the cell state on the saturating Q8.8 grid) through the
  LSTM kernel of :mod:`repro_torch.kernels.delta_q8`.
* ``"fused_batch"`` / ``"fused_q8_batch"`` / ``"fused_q4_batch"`` — the
  same kernels over a ``[B, ...]`` tile of streams; they reject streamless
  inputs.

A sequence runs as a Python loop over time; nothing in a step synchronises
the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core.backends import (BackendSpec, batched_step, get_backend,
                                       quant_acts_message, register_backend,
                                       require_default_acts)
from repro_torch.core.delta import DeltaState, delta_encode, init_delta_state
from repro_torch.core.thresholds import layer_theta


class LstmLayerParams(NamedTuple):
    w_x: torch.Tensor  # [4H, I]   gates (i,f,g,o) stacked on axis 0
    w_h: torch.Tensor  # [4H, H]
    b: torch.Tensor    # [4H]

    @property
    def hidden_size(self) -> int:
        return self.w_h.shape[-1]

    @property
    def input_size(self) -> int:
        return self.w_x.shape[-1]

    def to(self, device) -> "LstmLayerParams":
        return LstmLayerParams(*(t.to(device) for t in self))


def init_lstm_layer(generator: torch.Generator, input_size: int,
                    hidden_size: int, dtype=torch.float32,
                    forget_bias: float = 1.0) -> LstmLayerParams:
    """Glorot-uniform weights drawn on the CPU from ``generator``; zero
    biases except the forget gate's, ``forget_bias``."""
    sx = (6.0 / (input_size + 4 * hidden_size)) ** 0.5
    sh = (6.0 / (hidden_size + 4 * hidden_size)) ** 0.5
    w_x = (torch.rand((4 * hidden_size, input_size), generator=generator,
                      dtype=dtype) * 2 - 1) * sx
    w_h = (torch.rand((4 * hidden_size, hidden_size), generator=generator,
                      dtype=dtype) * 2 - 1) * sh
    b = torch.zeros((4 * hidden_size,), dtype=dtype)
    b[hidden_size:2 * hidden_size] = forget_bias
    return LstmLayerParams(w_x=w_x, w_h=w_h, b=b)


def init_lstm_stack(generator: torch.Generator, input_size: int,
                    hidden_size: int, num_layers: int,
                    dtype=torch.float32) -> list[LstmLayerParams]:
    return [init_lstm_layer(generator, input_size if l == 0 else hidden_size,
                            hidden_size, dtype)
            for l in range(num_layers)]


def lstm_step(params: LstmLayerParams, carry, x: torch.Tensor,
              sigmoid: Callable = torch.sigmoid,
              tanh: Callable = torch.tanh):
    """Reference LSTM cell. ``carry = (h, c)``; returns the new pair."""
    h_prev, c_prev = carry
    z = x @ params.w_x.T + h_prev @ params.w_h.T + params.b
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    i, f, o = sigmoid(zi), sigmoid(zf), sigmoid(zo)
    g = tanh(zg)
    c = f * c_prev + i * g
    h = o * tanh(c)
    return (h, c)


class DeltaLstmLayerState(NamedTuple):
    h: torch.Tensor       # [..., H] hidden state
    c: torch.Tensor       # [..., H] cell state
    x_mem: DeltaState     # x_hat  [..., I]
    h_mem: DeltaState     # h_hat  [..., H]
    m: torch.Tensor       # [..., 4H] delta memories (M_i, M_f, M_g, M_o)


def init_deltalstm_state(params: LstmLayerParams, batch_shape=(), dtype=None,
                         m_init: str = "bias") -> DeltaLstmLayerState:
    """``m_init="bias"`` folds the biases into the delta memories up front;
    ``"zero"`` (the ``fused_q8`` / ``fused_q4`` convention) leaves ``M``
    the all-zero code-domain accumulator whose quantized bias lives in the
    packed layout. The state lives on the device of the params."""
    dtype = dtype or params.w_x.dtype
    dev = params.w_x.device
    h_dim, i_dim = params.hidden_size, params.input_size
    if m_init == "zero":
        m0 = torch.zeros((4 * h_dim,), dtype=dtype, device=dev)
    else:
        m0 = params.b.to(dtype)
    m0 = m0.expand(*batch_shape, 4 * h_dim).contiguous()
    return DeltaLstmLayerState(
        h=torch.zeros((*batch_shape, h_dim), dtype=dtype, device=dev),
        c=torch.zeros((*batch_shape, h_dim), dtype=dtype, device=dev),
        x_mem=init_delta_state((*batch_shape, i_dim), dtype, dev),
        h_mem=init_delta_state((*batch_shape, h_dim), dtype, dev),
        m=m0)


class DeltaLstmStepOut(NamedTuple):
    h: torch.Tensor
    state: DeltaLstmLayerState
    delta_x: torch.Tensor   # the (sparse) encoded input delta actually used
    delta_h: torch.Tensor   # the (sparse) encoded hidden delta actually used


def _kernel_layer_step(kernel_step, layout, params: LstmLayerParams,
                       state: DeltaLstmLayerState, dx_out, dh_out):
    """One fused LSTM layer-step kernel (batch dims flattened)."""
    h_dim, i_dim = params.hidden_size, params.input_size
    lead = state.h.shape[:-1]
    m_new, h_new, c_new = kernel_step(
        layout, state.m.reshape(-1, 4 * h_dim).contiguous(),
        state.h.reshape(-1, h_dim).contiguous(),
        state.c.reshape(-1, h_dim).contiguous(),
        dx_out.delta.reshape(-1, i_dim).contiguous(),
        dh_out.delta.reshape(-1, h_dim).contiguous())
    h_new = h_new.reshape(*lead, h_dim)
    new_state = DeltaLstmLayerState(
        h=h_new, c=c_new.reshape(*lead, h_dim), x_mem=dx_out.state,
        h_mem=dh_out.state, m=m_new.reshape(*lead, 4 * h_dim))
    return DeltaLstmStepOut(h=h_new, state=new_state, delta_x=dx_out.delta,
                            delta_h=dh_out.delta)


# -- per-backend step implementations (registered BackendSpec.step fns) -----

def _step_dense(params, state, x, theta_x, theta_h, *, layout,
                sigmoid=torch.sigmoid, tanh=torch.tanh):
    """The delta update with plain matmuls (zeros in the deltas are
    multiplied); the one backend that honours custom (QAT) activations."""
    dx_out = delta_encode(x, state.x_mem, theta_x)
    dh_out = delta_encode(state.h, state.h_mem, theta_h)
    m = state.m + dx_out.delta @ params.w_x.T + dh_out.delta @ params.w_h.T
    zi, zf, zg, zo = torch.chunk(m, 4, dim=-1)
    i, f, o = sigmoid(zi), sigmoid(zf), sigmoid(zo)
    g = tanh(zg)
    c = f * state.c + i * g
    h = o * tanh(c)
    new_state = DeltaLstmLayerState(h=h, c=c, x_mem=dx_out.state,
                                    h_mem=dh_out.state, m=m)
    return DeltaLstmStepOut(h=h, state=new_state, delta_x=dx_out.delta,
                            delta_h=dh_out.delta)


def _step_fused(params, state, x, theta_x, theta_h, *, layout,
                sigmoid=torch.sigmoid, tanh=torch.tanh):
    from repro_torch.kernels import deltalstm_seq as _seq
    require_default_acts(sigmoid, tanh, "fused backend hard-codes the "
                         "i/f/g/o activation pipeline; pass "
                         "backend='dense' for custom/QAT activations")
    if layout is None:
        layout = _seq.pack_lstm_layer(params.w_x, params.w_h)
    dx_out = delta_encode(x, state.x_mem, theta_x)
    dh_out = delta_encode(state.h, state.h_mem, theta_h)
    return _kernel_layer_step(_seq.deltalstm_seq_step, layout, params, state,
                              dx_out, dh_out)


def _step_fused_quant(bits: int, params, state, x, theta_x, theta_h, *,
                      layout, sigmoid, tanh):
    from repro_torch.kernels import delta_q8 as _q8
    require_default_acts(sigmoid, tanh, quant_acts_message(f"fused_q{bits}"))
    if layout is None:
        layout = _q8.pack_delta_weights_q8(params.w_x, params.w_h,
                                           b=params.b, gates=4,
                                           weight_bits=bits)
    # The Delta Unit sees the Q8.8-quantized input stream (layer >= 2
    # inputs are already on-grid hidden states; re-rounding is exact).
    x = layout.quantize_act(x)
    dx_out = delta_encode(x, state.x_mem, theta_x)
    dh_out = delta_encode(state.h, state.h_mem, theta_h)
    return _kernel_layer_step(_q8.deltalstm_q8_step, layout, params, state,
                              dx_out, dh_out)


def _step_fused_q8(params, state, x, theta_x, theta_h, *, layout,
                   sigmoid=torch.sigmoid, tanh=torch.tanh):
    return _step_fused_quant(8, params, state, x, theta_x, theta_h,
                             layout=layout, sigmoid=sigmoid, tanh=tanh)


def _step_fused_q4(params, state, x, theta_x, theta_h, *, layout,
                   sigmoid=torch.sigmoid, tanh=torch.tanh):
    """The int4 twin of :func:`_step_fused_q8`; the kernel dispatches on
    ``layout.weight_bits``."""
    return _step_fused_quant(4, params, state, x, theta_x, theta_h,
                             layout=layout, sigmoid=sigmoid, tanh=tanh)


_step_fused_batch = batched_step("fused_batch", _step_fused)
_step_fused_q8_batch = batched_step("fused_q8_batch", _step_fused_q8)
_step_fused_q4_batch = batched_step("fused_q4_batch", _step_fused_q4)


# -- per-backend stack packers (registered BackendSpec.pack fns) ------------

def _pack_none(params, block):
    return params, None


def _pack_fused(params, block):
    from repro_torch.kernels.deltalstm_seq import pack_lstm_layer
    return params, [pack_lstm_layer(p.w_x, p.w_h, block_h=block,
                                    block_k=block)
                    for p in params]


def _pack_fused_q8(params, block):
    # quantize-and-pack: the returned stack is the dequantized fake-quant
    # view, so plain versions / state init see the grids the kernel streams.
    from repro_torch.quant.export import quantize_delta_stack
    return quantize_delta_stack(params, cell="lstm", block=block)


def _pack_fused_q4(params, block):
    from repro_torch.quant.export import quantize_delta_stack
    return quantize_delta_stack(params, cell="lstm", block=block, bits=4)


register_backend(BackendSpec(
    name="dense", cell="lstm", pack=_pack_none, step=_step_dense,
    m_init="bias", weight_bits=32))
register_backend(BackendSpec(
    name="fused", cell="lstm", pack=_pack_fused, step=_step_fused,
    m_init="bias", weight_bits=32))
register_backend(BackendSpec(
    name="fused_q8", cell="lstm", pack=_pack_fused_q8, step=_step_fused_q8,
    m_init="zero", weight_bits=8))
# Batched tiles share their parent's pack fn (and so its layouts and m_init),
# so DeltaProgram.with_backend swaps between the pair without repacking.
register_backend(BackendSpec(
    name="fused_batch", cell="lstm", pack=_pack_fused,
    step=_step_fused_batch, m_init="bias", weight_bits=32,
    weight_fetch="tile"))
register_backend(BackendSpec(
    name="fused_q8_batch", cell="lstm", pack=_pack_fused_q8,
    step=_step_fused_q8_batch, m_init="zero", weight_bits=8,
    weight_fetch="tile"))
register_backend(BackendSpec(
    name="fused_q4", cell="lstm", pack=_pack_fused_q4, step=_step_fused_q4,
    m_init="zero", weight_bits=4))
register_backend(BackendSpec(
    name="fused_q4_batch", cell="lstm", pack=_pack_fused_q4,
    step=_step_fused_q4_batch, m_init="zero", weight_bits=4,
    weight_fetch="tile"))


def lstm_stack_m_init(backend: str) -> str:
    """M-memory init convention for an LSTM backend."""
    return get_backend(backend, cell="lstm").m_init


def deltalstm_step(params: LstmLayerParams, state: DeltaLstmLayerState,
                   x: torch.Tensor, theta_x, theta_h,
                   sigmoid: Callable = torch.sigmoid,
                   tanh: Callable = torch.tanh, backend: str = "dense",
                   layout=None) -> DeltaLstmStepOut:
    """One DeltaLSTM timestep through the ``cell="lstm"`` registry.
    ``state`` must follow the backend's ``m_init`` convention; ``layout``
    is the pre-packed layer (packed on the fly otherwise). Custom
    ``sigmoid`` / ``tanh`` run on ``dense`` only; the kernel backends
    raise ``ValueError``."""
    spec = get_backend(backend, cell="lstm")
    return spec.step(params, state, x, theta_x, theta_h, layout=layout,
                     sigmoid=sigmoid, tanh=tanh)


# ---------------------------------------------------------------------------
# Multi-layer stacks over sequences
# ---------------------------------------------------------------------------

class DeltaLstmStackState(NamedTuple):
    layers: tuple  # tuple[DeltaLstmLayerState, ...]


def init_deltalstm_stack_state(params: Sequence[LstmLayerParams],
                               batch_shape=(), dtype=None,
                               m_init: str = "bias") -> DeltaLstmStackState:
    return DeltaLstmStackState(
        layers=tuple(init_deltalstm_state(p, batch_shape, dtype,
                                          m_init=m_init)
                     for p in params))


def deltalstm_stack_step(params: Sequence[LstmLayerParams],
                         state: DeltaLstmStackState, x: torch.Tensor,
                         theta_x, theta_h, backend: str = "dense",
                         layouts=None, sigmoid: Callable = torch.sigmoid,
                         tanh: Callable = torch.tanh):
    """One timestep through all layers; the input threshold of layers >= 2
    applies to the previous layer's output stream, as in the GRU stack."""
    new_layers = []
    deltas = []
    inp = x
    for li, (p, st) in enumerate(zip(params, state.layers)):
        out = deltalstm_step(
            p, st, inp, layer_theta(theta_x, li), layer_theta(theta_h, li),
            sigmoid=sigmoid, tanh=tanh, backend=backend,
            layout=layouts[li] if layouts is not None else None)
        new_layers.append(out.state)
        deltas.append((out.delta_x, out.delta_h))
        inp = out.h
    return inp, DeltaLstmStackState(tuple(new_layers)), deltas


def pack_lstm_stack(params: Sequence[LstmLayerParams], backend: str,
                    block: int = 128):
    """Pre-pack every layer for a kernel backend, once; returns the
    per-layer layouts (``None`` for ``dense``), the LSTM spelling of
    :func:`repro_torch.core.deltagru.pack_stack`."""
    return get_backend(backend, cell="lstm").pack(params, block)[1]


def deltalstm_sequence(params: Sequence[LstmLayerParams], xs: torch.Tensor,
                       theta_x, theta_h,
                       init_state: DeltaLstmStackState | None = None,
                       collect_sparsity: bool = True,
                       backend: str = "dense", layouts=None,
                       sigmoid: Callable = torch.sigmoid,
                       tanh: Callable = torch.tanh):
    """Run a DeltaLSTM stack over ``xs: [T, B, I]`` (a Python loop over T).

    Kernel backends get their weights packed once here, or take pre-packed
    ``layouts``. Returns ``(ys [T, B, H], final_state, stats)``, where stats
    holds the measured firing fractions for Eq. 4 if ``collect_sparsity``.
    """
    if init_state is None:
        init_state = init_deltalstm_stack_state(
            params, xs.shape[1:-1], xs.dtype,
            m_init=lstm_stack_m_init(backend))
    if layouts is None:
        layouts = pack_lstm_stack(params, backend)
    state = init_state
    ys = []
    per_layer = [([], []) for _ in params]
    for x in xs:
        y, state, deltas = deltalstm_stack_step(params, state, x, theta_x,
                                                theta_h, backend=backend,
                                                layouts=layouts,
                                                sigmoid=sigmoid, tanh=tanh)
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


def lstm_sequence(params: Sequence[LstmLayerParams], xs: torch.Tensor,
                  sigmoid: Callable = torch.sigmoid,
                  tanh: Callable = torch.tanh):
    """Reference multi-layer LSTM over ``xs: [T, B, I]`` (the oracle)."""
    batch_shape = xs.shape[1:-1]
    carries = [(torch.zeros((*batch_shape, p.hidden_size), dtype=xs.dtype,
                            device=xs.device),) * 2 for p in params]
    ys = []
    for x in xs:
        inp = x
        for li, p in enumerate(params):
            carries[li] = lstm_step(p, carries[li], inp, sigmoid, tanh)
            inp = carries[li][0]
        ys.append(inp)
    return torch.stack(ys)
