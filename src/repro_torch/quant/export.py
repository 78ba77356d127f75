"""Export trained delta-RNN stacks (``cell="gru"`` or ``"lstm"``) into the
packed int8 / int4 runtime format, the PyTorch port of
:mod:`repro.quant.export`.

:func:`quantize_delta_stack` converts a trained fp32 or QAT layer stack into
per-layer :class:`~repro_torch.kernels.delta_q8.QuantDeltaLayout` packs
(what the ``fused_q8`` / ``fused_q4`` kernels stream) and a matching
fake-quant view stack whose fp32 values are the dequantized codes, with
biases rounded onto the Q8.8 grid. :func:`quantize_delta_model` returns a
ready-to-run program from a model params dict (the head stays fp32).
"""
from __future__ import annotations

from repro_torch.core.sparsity import CELL_GATES
from repro_torch.kernels.delta_q8 import (QuantDeltaLayout, _layout_codes_f32,
                                          pack_delta_weights_q8)

#: streamed weight widths with a packed runtime grid
SUPPORTED_WEIGHT_BITS = (4, 8)


def quantize_delta_stack(params, cell: str = "gru", block: int = 128,
                         act_frac_bits: int = 8, act_int_bits: int = 8,
                         lut_frac_bits: int = 4,
                         with_ref_codes: bool | None = None,
                         bits: int = 8):
    """Quantize a trained delta-RNN stack into the packed runtime format.

    Returns ``(qparams, layouts)``: the fake-quant view stack and the
    per-layer packs, on the device of the params (the packing itself runs
    on the CPU, see :func:`pack_delta_weights_q8`). ``bits`` is 8 (int8
    codes) or 4 (nibble-packed int4).
    """
    if cell not in CELL_GATES:
        raise ValueError(f"unknown cell family {cell!r}; known gate "
                         f"counts: {CELL_GATES}")
    if bits not in SUPPORTED_WEIGHT_BITS:
        raise ValueError(
            f"bits={bits!r} is not a packed runtime width; the quantized "
            f"delta kernels stream int8 or nibble-packed int4 codes only "
            f"(bits in {SUPPORTED_WEIGHT_BITS})")
    gates = CELL_GATES[cell]
    qparams, layouts = [], []
    for li, p in enumerate(params):
        h = p.w_h.shape[-1]
        if p.w_x.shape[0] != gates * h:
            raise ValueError(
                f"cell={cell!r} expects [{gates}H, I] gate rows; layer "
                f"{li} has w_x {tuple(p.w_x.shape)} for hidden size {h} — "
                "wrong cell family?")
        lay = pack_delta_weights_q8(
            p.w_x, p.w_h, b=p.b, gates=gates, block_h=block, block_k=block,
            act_frac_bits=act_frac_bits, act_int_bits=act_int_bits,
            lut_frac_bits=lut_frac_bits, with_ref_codes=with_ref_codes,
            weight_bits=bits)
        layouts.append(lay)
        qparams.append(type(p)(w_x=_dequant_slice(lay, "x"),
                               w_h=_dequant_slice(lay, "h"),
                               b=_bias_view(lay)))
    return qparams, layouts


def quantize_stack(params, block: int = 128, act_frac_bits: int = 8,
                   act_int_bits: int = 8, lut_frac_bits: int = 4,
                   with_ref_codes: bool | None = None, bits: int = 8):
    """GRU-pinned spelling of :func:`quantize_delta_stack`."""
    return quantize_delta_stack(
        params, cell="gru", block=block, act_frac_bits=act_frac_bits,
        act_int_bits=act_int_bits, lut_frac_bits=lut_frac_bits,
        with_ref_codes=with_ref_codes, bits=bits)


def quantize_delta_model(params: dict, cell: str | None = None,
                         bits: int = 8, device=None, **kw):
    """Quantize a model params dict (head left fp32) into a ready-to-run
    ``fused_q8`` (``bits=8``) or ``fused_q4`` (``bits=4``) program on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``)."""
    from repro_torch.core.program import DeltaProgram, infer_cell
    from repro_torch.kernels.ops import resolve_device
    dev = resolve_device(device)
    if cell is None:
        cell = infer_cell(params)
    if not isinstance(params, dict) or cell not in params:
        keys = sorted(params) if isinstance(params, dict) else type(params)
        raise ValueError(
            f"quantize_delta_model(cell={cell!r}) needs a model params "
            f"dict with a {cell!r} stack; got {keys} — for a bare layer "
            "stack use quantize_delta_stack(params, cell=...)")
    stack = [p.to(dev) for p in params[cell]]
    qstack, layouts = quantize_delta_stack(stack, cell=cell, bits=bits, **kw)
    head, head_b = params.get("head"), params.get("head_b")
    return DeltaProgram(
        layers=tuple(qstack), layouts=tuple(layouts),
        head=head.to(dev) if head is not None else None,
        head_b=head_b.to(dev) if head_b is not None else None,
        backend="fused_q8" if bits == 8 else "fused_q4", cell=cell)


def quantize_gru_model(params: dict, **kw):
    """GRU-pinned spelling of :func:`quantize_delta_model`; a non-GRU model
    dict raises instead of mis-packing its gate rows."""
    if isinstance(params, dict) and "gru" not in params:
        raise ValueError(
            f"quantize_gru_model quantizes init_gru_model params dicts "
            f"(a 'gru' stack); got keys {sorted(params)}")
    return quantize_delta_model(params, cell="gru", **kw)


def _dequant_slice(lay: QuantDeltaLayout, which: str):
    h, i = lay.hidden_size, lay.input_size
    codes = _layout_codes_f32(lay)
    if which == "x":
        sl = codes[:, :h, :i]
    else:
        sl = codes[:, :h, lay.ip:lay.ip + h]
    w = sl * lay.scales[:, :h, None]
    return w.reshape(lay.gates * h, sl.shape[-1])


def _bias_view(lay: QuantDeltaLayout):
    h = lay.hidden_size
    return lay.b4[:lay.gates, :h].reshape(lay.gates * h)
