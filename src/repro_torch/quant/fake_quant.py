"""Fixed-point grids (paper Sec. IV-A), the PyTorch port of
:mod:`repro.quant.fake_quant`.

Qm.n fixed point: Q8.8 activations, int8 (or int4) weights. ``quantize``
rounds half to even (``torch.round``, like ``jnp.round``) and then clips,
the op sequence every packed kernel and plain version shares.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class QFormat:
    """Signed fixed-point format Qm.n: m integer bits, n fraction bits.

    Total width = 1 (sign) + m + n. Range [-2^m, 2^m - 2^-n], step 2^-n.
    """

    int_bits: int
    frac_bits: int

    @property
    def bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def min_val(self) -> float:
        return -float(2 ** self.int_bits)

    @property
    def max_val(self) -> float:
        return float(2 ** self.int_bits) - 1.0 / self.scale


# Paper's operating formats.
ACT_Q88 = QFormat(8, 8)      # INT16 activations
WGT_Q17 = QFormat(0, 7)      # INT8 weights, |w| < 1
WGT_Q13 = QFormat(0, 3)      # INT4 weights (nibble-packed fused_q4 grid)
LUT_Q14 = QFormat(1, 4)      # 5-bit LUT output (best RMSE in the paper)

#: streamed weight widths with a packed runtime kernel behind them
WEIGHT_BITS_FORMATS = {8: WGT_Q17, 4: WGT_Q13}


def weight_format_for_bits(bits: int) -> QFormat:
    """The weight grid matching a streamed width (8 -> Q0.7, 4 -> Q0.3).
    Other widths raise: there is no packed kernel to serve them."""
    try:
        return WEIGHT_BITS_FORMATS[bits]
    except KeyError:
        raise ValueError(
            f"no weight grid for bits={bits!r}; supported widths: "
            f"{sorted(WEIGHT_BITS_FORMATS)} (int8 / nibble-packed int4)"
        ) from None


def quantize(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Round-to-nearest-even onto the Qm.n grid (float carrying the grid)."""
    q = torch.round(x * fmt.scale) / fmt.scale
    return torch.clamp(q, fmt.min_val, fmt.max_val)


def dequantize(q_int: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Integer codes -> float values."""
    return q_int.to(torch.float32) / fmt.scale


def to_int(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Float -> integer codes (for storage-size accounting / export)."""
    q = torch.clamp(torch.round(x * fmt.scale), fmt.min_val * fmt.scale,
                    fmt.max_val * fmt.scale)
    bits = fmt.bits
    dt = (torch.int8 if bits <= 8
          else torch.int16 if bits <= 16 else torch.int32)
    return q.to(dt)


def fake_quant(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """STE fake-quant: forward = quantize, backward = identity."""
    return x + (quantize(x, fmt) - x).detach()


def quant_params(params, fmt: QFormat = WGT_Q17):
    """Fake-quantize every tensor of a list / tuple / dict of parameters."""
    if isinstance(params, torch.Tensor):
        return fake_quant(params, fmt)
    if isinstance(params, dict):
        return {k: quant_params(v, fmt) for k, v in params.items()}
    if isinstance(params, tuple) and hasattr(params, "_fields"):
        return type(params)(*(quant_params(v, fmt) for v in params))
    if isinstance(params, (list, tuple)):
        return type(params)(quant_params(v, fmt) for v in params)
    return params
