"""DeltaGRU (EdgeDRNN Eq. 1-3), the PyTorch port of :mod:`repro.core.deltagru`.

A DeltaGRU layer keeps, per stream: state memories ``x_hat`` / ``h_hat``
(Eq. 2), four delta memories ``M_r, M_u, M_xc, M_hc`` holding running
partial sums (Eq. 3), and the hidden state ``h``. Gate order is ``r, u,
c``; ``W_x: [3H, I]``, ``W_h: [3H, H]``.

Backends (each a registered :class:`repro_torch.core.backends.BackendSpec`):

* ``"dense"`` — plain matmuls; zeros in the deltas are multiplied. The
  one backend that takes custom ``sigmoid=`` / ``tanh=`` (the QAT LUTs);
  the kernel backends below raise on them.
* ``"fused"`` — one launch of the fp32 fused layer-step kernel per layer
  step (:mod:`repro_torch.kernels.deltagru_seq`).
* ``"fused_q8"`` / ``"fused_q4"`` — the fixed-point pipeline (int8 codes,
  or nibble-packed int4 codes, Q8.8 activations, code-domain delta
  memories, Q1.4 LUT activations) through the kernel of
  :mod:`repro_torch.kernels.delta_q8`.
* ``"fused_batch"`` / ``"fused_q8_batch"`` / ``"fused_q4_batch"`` — the
  same kernels over a ``[B, ...]`` tile of streams: one weight pass per
  tile, compacted on the union of fired columns. They reject streamless
  inputs.

The kernel backends launch their CUDA kernel when the state lies on a CUDA
device and run the kernel's plain version on the CPU. A sequence runs as a
Python loop over time (the JAX package's ``lax.scan``); nothing in a step
synchronises the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core.backends import (BackendSpec, batched_step, get_backend,
                                       quant_acts_message, register_backend,
                                       require_default_acts)
from repro_torch.core.delta import DeltaState, delta_encode, init_delta_state
from repro_torch.core.thresholds import layer_theta


class GruLayerParams(NamedTuple):
    w_x: torch.Tensor  # [3H, I]   gates (r,u,c) stacked on axis 0
    w_h: torch.Tensor  # [3H, H]
    b: torch.Tensor    # [3H]

    @property
    def hidden_size(self) -> int:
        return self.w_h.shape[-1]

    @property
    def input_size(self) -> int:
        return self.w_x.shape[-1]

    def to(self, device) -> "GruLayerParams":
        return GruLayerParams(*(t.to(device) for t in self))


def init_gru_layer(generator: torch.Generator, input_size: int,
                   hidden_size: int, dtype=torch.float32) -> GruLayerParams:
    """Glorot-uniform weights, zero biases, drawn on the CPU from
    ``generator``."""
    sx = (6.0 / (input_size + 3 * hidden_size)) ** 0.5
    sh = (6.0 / (hidden_size + 3 * hidden_size)) ** 0.5
    w_x = (torch.rand((3 * hidden_size, input_size), generator=generator,
                      dtype=dtype) * 2 - 1) * sx
    w_h = (torch.rand((3 * hidden_size, hidden_size), generator=generator,
                      dtype=dtype) * 2 - 1) * sh
    return GruLayerParams(w_x=w_x, w_h=w_h,
                          b=torch.zeros((3 * hidden_size,), dtype=dtype))


def init_gru_stack(generator: torch.Generator, input_size: int,
                   hidden_size: int, num_layers: int,
                   dtype=torch.float32) -> list[GruLayerParams]:
    return [init_gru_layer(generator, input_size if l == 0 else hidden_size,
                           hidden_size, dtype)
            for l in range(num_layers)]


# ---------------------------------------------------------------------------
# Reference GRU (Eq. 1)
# ---------------------------------------------------------------------------

def gru_step(params: GruLayerParams, h_prev: torch.Tensor, x: torch.Tensor,
             sigmoid: Callable = torch.sigmoid,
             tanh: Callable = torch.tanh) -> torch.Tensor:
    """Standard GRU cell update (Eq. 1). ``x: [..., I]``, ``h: [..., H]``."""
    zx = x @ params.w_x.T + params.b            # [..., 3H]
    zh = h_prev @ params.w_h.T                  # [..., 3H]
    rx, ux, cx = torch.chunk(zx, 3, dim=-1)
    rh, uh, ch = torch.chunk(zh, 3, dim=-1)
    r = sigmoid(rx + rh)
    u = sigmoid(ux + uh)
    c = tanh(cx + r * ch)
    return (1.0 - u) * c + u * h_prev


# ---------------------------------------------------------------------------
# DeltaGRU (Eq. 2 + 3)
# ---------------------------------------------------------------------------

class DeltaGruLayerState(NamedTuple):
    h: torch.Tensor       # [..., H] hidden state
    x_mem: DeltaState     # x_hat  [..., I]
    h_mem: DeltaState     # h_hat  [..., H]
    m: torch.Tensor       # [..., 4H] delta memories (M_r, M_u, M_xc, M_hc)


def init_deltagru_state(params: GruLayerParams, batch_shape=(), dtype=None,
                        m_init: str = "bias") -> DeltaGruLayerState:
    """Paper init: ``M_r = b_r, M_u = b_u, M_xc = b_c, M_hc = 0``; states 0.

    ``m_init="zero"`` (the ``fused_q8`` / ``fused_q4`` convention) leaves
    ``M`` all-zero: the code-domain accumulator, whose quantized bias lives
    in the packed layout. The state lives on the device of the params.
    """
    dtype = dtype or params.w_x.dtype
    dev = params.w_x.device
    h_dim, i_dim = params.hidden_size, params.input_size
    if m_init == "zero":
        m0 = torch.zeros((4 * h_dim,), dtype=dtype, device=dev)
    else:
        b_r, b_u, b_c = torch.chunk(params.b.to(dtype), 3)
        m0 = torch.cat([b_r, b_u, b_c,
                        torch.zeros((h_dim,), dtype=dtype, device=dev)])
    m0 = m0.expand(*batch_shape, 4 * h_dim).contiguous()
    return DeltaGruLayerState(
        h=torch.zeros((*batch_shape, h_dim), dtype=dtype, device=dev),
        x_mem=init_delta_state((*batch_shape, i_dim), dtype, dev),
        h_mem=init_delta_state((*batch_shape, h_dim), dtype, dev),
        m=m0,
    )


class DeltaGruStepOut(NamedTuple):
    h: torch.Tensor
    state: DeltaGruLayerState
    delta_x: torch.Tensor   # the (sparse) encoded input delta actually used
    delta_h: torch.Tensor   # the (sparse) encoded hidden delta actually used


def _kernel_layer_step(kernel_step, layout, params: GruLayerParams,
                       state: DeltaGruLayerState, dx_out, dh_out):
    """Eq. 3 through one fused layer-step kernel (batch dims flattened)."""
    h_dim, i_dim = params.hidden_size, params.input_size
    lead = state.h.shape[:-1]
    m_new, h_new = kernel_step(
        layout, state.m.reshape(-1, 4 * h_dim).contiguous(),
        state.h.reshape(-1, h_dim).contiguous(),
        dx_out.delta.reshape(-1, i_dim).contiguous(),
        dh_out.delta.reshape(-1, h_dim).contiguous())
    h_new = h_new.reshape(*lead, h_dim)
    new_state = DeltaGruLayerState(
        h=h_new, x_mem=dx_out.state, h_mem=dh_out.state,
        m=m_new.reshape(*lead, 4 * h_dim))
    return DeltaGruStepOut(h=h_new, state=new_state,
                           delta_x=dx_out.delta, delta_h=dh_out.delta)


# -- per-backend step implementations (registered BackendSpec.step fns) -----

def _step_dense(params, state, x, theta_x, theta_h, *, layout,
                sigmoid=torch.sigmoid, tanh=torch.tanh):
    """Eq. 3 with plain matmuls (zeros in the deltas are multiplied); the
    one backend that honours custom (QAT) activations."""
    dx_out = delta_encode(x, state.x_mem, theta_x)
    dh_out = delta_encode(state.h, state.h_mem, theta_h)
    dx, dh = dx_out.delta, dh_out.delta
    zx = dx @ params.w_x.T                      # [..., 3H] = W_x @ dx
    zh = dh @ params.w_h.T                      # [..., 3H] = W_h @ dh
    m_r, m_u, m_xc, m_hc = torch.chunk(state.m, 4, dim=-1)
    zxr, zxu, zxc = torch.chunk(zx, 3, dim=-1)
    zhr, zhu, zhc = torch.chunk(zh, 3, dim=-1)
    m_r = m_r + zxr + zhr
    m_u = m_u + zxu + zhu
    m_xc = m_xc + zxc
    m_hc = m_hc + zhc
    r = sigmoid(m_r)
    u = sigmoid(m_u)
    c = tanh(m_xc + r * m_hc)
    h = (1.0 - u) * c + u * state.h
    new_state = DeltaGruLayerState(
        h=h, x_mem=dx_out.state, h_mem=dh_out.state,
        m=torch.cat([m_r, m_u, m_xc, m_hc], dim=-1))
    return DeltaGruStepOut(h=h, state=new_state, delta_x=dx, delta_h=dh)


def _step_fused(params, state, x, theta_x, theta_h, *, layout,
                sigmoid=torch.sigmoid, tanh=torch.tanh):
    from repro_torch.kernels import deltagru_seq as _seq
    require_default_acts(sigmoid, tanh, "fused backend hard-codes the "
                         "Fig. 7 activation pipeline; pass backend='dense' "
                         "for custom/QAT activations")
    if layout is None:
        layout = _seq.pack_gru_layer(params.w_x, params.w_h)
    dx_out = delta_encode(x, state.x_mem, theta_x)
    dh_out = delta_encode(state.h, state.h_mem, theta_h)
    return _kernel_layer_step(_seq.deltagru_seq_step, layout, params, state,
                              dx_out, dh_out)


def _step_fused_quant(bits: int, params, state, x, theta_x, theta_h, *,
                      layout, sigmoid, tanh):
    from repro_torch.kernels import delta_q8 as _q8
    require_default_acts(sigmoid, tanh, quant_acts_message(f"fused_q{bits}"))
    if layout is None:
        layout = _q8.pack_delta_weights_q8(params.w_x, params.w_h,
                                           b=params.b, weight_bits=bits)
    # The Delta Unit sees the Q8.8-quantized input stream (layer >= 2
    # inputs are already on-grid hidden states; re-rounding is exact).
    x = layout.quantize_act(x)
    dx_out = delta_encode(x, state.x_mem, theta_x)
    dh_out = delta_encode(state.h, state.h_mem, theta_h)
    return _kernel_layer_step(_q8.deltagru_q8_step, layout, params, state,
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
    from repro_torch.kernels.deltagru_seq import pack_gru_layer
    return params, [pack_gru_layer(p.w_x, p.w_h, block_h=block,
                                   block_k=block)
                    for p in params]


def _pack_fused_q8(params, block):
    # quantize-and-pack: the returned stack is the dequantized fake-quant
    # view, so plain versions / state init see the grids the kernel streams.
    from repro_torch.quant.export import quantize_stack
    return quantize_stack(params, block=block)


def _pack_fused_q4(params, block):
    from repro_torch.quant.export import quantize_stack
    return quantize_stack(params, block=block, bits=4)


register_backend(BackendSpec(
    name="dense", cell="gru", pack=_pack_none, step=_step_dense,
    m_init="bias", weight_bits=32))
register_backend(BackendSpec(
    name="fused", cell="gru", pack=_pack_fused, step=_step_fused,
    m_init="bias", weight_bits=32))
register_backend(BackendSpec(
    name="fused_q8", cell="gru", pack=_pack_fused_q8, step=_step_fused_q8,
    m_init="zero", weight_bits=8))
# Batched tiles share their parent's pack fn (and so its layouts and m_init),
# so DeltaProgram.with_backend swaps between the pair without repacking.
register_backend(BackendSpec(
    name="fused_batch", cell="gru", pack=_pack_fused,
    step=_step_fused_batch, m_init="bias", weight_bits=32,
    weight_fetch="tile"))
register_backend(BackendSpec(
    name="fused_q8_batch", cell="gru", pack=_pack_fused_q8,
    step=_step_fused_q8_batch, m_init="zero", weight_bits=8,
    weight_fetch="tile"))
register_backend(BackendSpec(
    name="fused_q4", cell="gru", pack=_pack_fused_q4, step=_step_fused_q4,
    m_init="zero", weight_bits=4))
register_backend(BackendSpec(
    name="fused_q4_batch", cell="gru", pack=_pack_fused_q4,
    step=_step_fused_q4_batch, m_init="zero", weight_bits=4,
    weight_fetch="tile"))


def deltagru_step(params: GruLayerParams, state: DeltaGruLayerState,
                  x: torch.Tensor, theta_x, theta_h,
                  sigmoid: Callable = torch.sigmoid,
                  tanh: Callable = torch.tanh, backend: str = "dense",
                  layout=None) -> DeltaGruStepOut:
    """One DeltaGRU timestep (Eq. 3) through the backend registry.

    ``state`` must follow the backend's ``m_init`` convention (``"zero"``
    for ``fused_q8`` / ``fused_q4``); the program API enforces it.
    ``layout`` is the pre-packed layer (packed on the fly otherwise).
    ``sigmoid`` / ``tanh`` other than ``torch.sigmoid`` / ``torch.tanh``
    (the QAT LUTs of :meth:`repro_torch.quant.qat.QatPolicy.act_fns`) run
    on ``dense`` only; every kernel backend raises ``ValueError``.
    """
    spec = get_backend(backend, cell="gru")
    return spec.step(params, state, x, theta_x, theta_h, layout=layout,
                     sigmoid=sigmoid, tanh=tanh)


# ---------------------------------------------------------------------------
# Multi-layer stacks over sequences
# ---------------------------------------------------------------------------

class DeltaGruStackState(NamedTuple):
    layers: tuple  # tuple[DeltaGruLayerState, ...]


def init_deltagru_stack_state(params: Sequence[GruLayerParams],
                              batch_shape=(), dtype=None,
                              m_init: str = "bias") -> DeltaGruStackState:
    return DeltaGruStackState(
        layers=tuple(init_deltagru_state(p, batch_shape, dtype, m_init=m_init)
                     for p in params))


def stack_m_init(backend: str) -> str:
    """M-memory init convention for a backend (see init_deltagru_state)."""
    return get_backend(backend, cell="gru").m_init


def deltagru_stack_step(params: Sequence[GruLayerParams],
                        state: DeltaGruStackState, x: torch.Tensor,
                        theta_x, theta_h, backend: str = "dense",
                        layouts=None, sigmoid: Callable = torch.sigmoid,
                        tanh: Callable = torch.tanh):
    """One timestep through all layers. The input threshold of layers >= 2
    applies to the previous layer's output stream. ``theta_x`` /
    ``theta_h`` are scalars, 0-d tensors or per-layer tuples."""
    new_layers = []
    deltas = []
    inp = x
    for li, (p, st) in enumerate(zip(params, state.layers)):
        out = deltagru_step(
            p, st, inp, layer_theta(theta_x, li), layer_theta(theta_h, li),
            sigmoid=sigmoid, tanh=tanh, backend=backend,
            layout=layouts[li] if layouts is not None else None)
        new_layers.append(out.state)
        deltas.append((out.delta_x, out.delta_h))
        inp = out.h
    return inp, DeltaGruStackState(tuple(new_layers)), deltas


def pack_stack(params: Sequence[GruLayerParams], backend: str,
               block: int = 128):
    """Pre-pack every layer for a kernel backend, once; returns the
    per-layer layouts (``None`` for ``dense``). Prefer
    :func:`repro_torch.core.program.compile_deltagru`, which also keeps the
    rewritten stack and the state convention."""
    return get_backend(backend, cell="gru").pack(params, block)[1]


def deltagru_sequence(params: Sequence[GruLayerParams], xs: torch.Tensor,
                      theta_x, theta_h,
                      init_state: DeltaGruStackState | None = None,
                      collect_sparsity: bool = True,
                      backend: str = "dense", layouts=None,
                      sigmoid: Callable = torch.sigmoid,
                      tanh: Callable = torch.tanh):
    """Run a DeltaGRU stack over ``xs: [T, B, I]`` (a Python loop over T).

    Kernel backends get their weights packed once here, or take pre-packed
    ``layouts``. Returns ``(ys [T, B, H], final_state, stats)``, where stats
    holds the measured firing fractions for Eq. 4 if ``collect_sparsity``.
    """
    if init_state is None:
        init_state = init_deltagru_stack_state(params, xs.shape[1:-1],
                                               xs.dtype,
                                               m_init=stack_m_init(backend))
    if layouts is None:
        layouts = pack_stack(params, backend)
    state = init_state
    ys = []
    per_layer = [([], []) for _ in params]
    for x in xs:
        y, state, deltas = deltagru_stack_step(params, state, x, theta_x,
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


def gru_sequence(params: Sequence[GruLayerParams], xs: torch.Tensor,
                 sigmoid: Callable = torch.sigmoid,
                 tanh: Callable = torch.tanh):
    """Reference multi-layer GRU over ``xs: [T, B, I]`` (Eq. 1 oracle)."""
    batch_shape = xs.shape[1:-1]
    hs = [torch.zeros((*batch_shape, p.hidden_size), dtype=xs.dtype,
                      device=xs.device) for p in params]
    ys = []
    for x in xs:
        inp = x
        for li, p in enumerate(params):
            hs[li] = gru_step(p, hs[li], inp, sigmoid, tanh)
            inp = hs[li]
        ys.append(inp)
    return torch.stack(ys)
