"""LUT-based nonlinearities (paper Sec. III-C / IV-A), the PyTorch port of
:mod:`repro.quant.lut`.

EdgeDRNN's PEs evaluate sigmoid/tanh with look-up tables: Q8.8 input,
Q1.4..Q1.8 output. The LUT is modelled as output-grid rounding of the
exact function, which equals an input-indexed table of rounded values
because sigmoid/tanh are monotone and 1-Lipschitz and the Q8.8 input step
is finer than the output step. Training sees the LUT forward and the exact
function's gradient backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.quant.fake_quant import QFormat, quantize


@dataclass(frozen=True)
class LutNonlinearity:
    """A quantized nonlinearity with STE-to-exact-gradient behaviour."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    out_fmt: QFormat

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        exact = self.fn(x)
        lut = quantize(exact, self.out_fmt)
        # forward: LUT output; backward: exact function's gradient.
        return exact + (lut - exact).detach()

    def table(self, in_fmt: QFormat = QFormat(8, 8)) -> torch.Tensor:
        """The hardware table over the full input grid (2**bits entries)."""
        n = 2 ** in_fmt.bits
        codes = torch.arange(-(n // 2), n // 2,
                             dtype=torch.float32) / in_fmt.scale
        return quantize(self.fn(codes), self.out_fmt)


def lut_sigmoid(frac_bits: int = 4) -> LutNonlinearity:
    """Q1.n sigmoid LUT (paper default n=4)."""
    return LutNonlinearity(torch.sigmoid, QFormat(1, frac_bits))


def lut_tanh(frac_bits: int = 4) -> LutNonlinearity:
    return LutNonlinearity(torch.tanh, QFormat(1, frac_bits))
