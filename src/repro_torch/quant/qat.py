"""QAT policy: fixed-point fake quant and LUT nonlinearities wired into the
cells, the PyTorch port of :mod:`repro.quant.qat`.

The paper's recipe (Sec. IV-A): quantize weights and activations during
training with a straight-through estimator, use LUT-precision
nonlinearities in the forward pass and fp32 gradients backward.
:meth:`QatPolicy.act_fns` returns drop-in ``(sigmoid, tanh)`` callables for
the ``dense`` backend of :func:`repro_torch.core.deltagru.deltagru_step`
and its stacks; the kernel backends hard-code the deployment pipeline and
refuse them.

After QAT, export the trained stack with
:func:`repro_torch.quant.export.quantize_delta_model` and serve it on the
``backend="fused_q8"`` int8 kernel, the deployment-side counterpart of this
policy.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.quant.fake_quant import (ACT_Q88, WGT_Q17, QFormat,
                                          fake_quant, quant_params,
                                          weight_format_for_bits)
from repro_torch.quant.lut import lut_sigmoid, lut_tanh


@dataclass(frozen=True)
class QatPolicy:
    weight_fmt: QFormat = WGT_Q17
    act_fmt: QFormat = ACT_Q88
    lut_frac_bits: int = 4
    enabled: bool = True

    @classmethod
    def for_weight_bits(cls, bits: int, **kw) -> "QatPolicy":
        """A policy whose weight grid matches a streamed width (8 = the
        paper's int8 Q0.7, 4 = the ``fused_q4`` int4 Q0.3 grid); widths
        without a packed kernel raise."""
        return cls(weight_fmt=weight_format_for_bits(bits), **kw)

    @property
    def weight_bits(self) -> int:
        """Total streamed weight width of this policy's grid."""
        return self.weight_fmt.bits

    def quantize_params(self, params):
        """Fake-quantize a tensor or every tensor of a dict, list, tuple or
        NamedTuple (such as a ``GruLayerParams``) onto the weight grid."""
        if not self.enabled:
            return params
        return quant_params(params, self.weight_fmt)

    def quantize_act(self, x: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return x
        return fake_quant(x, self.act_fmt)

    def act_fns(self):
        """(sigmoid, tanh) honouring the LUT output precision; the default
        pair (``torch.sigmoid``, ``torch.tanh``) when disabled."""
        if not self.enabled:
            return torch.sigmoid, torch.tanh
        return lut_sigmoid(self.lut_frac_bits), lut_tanh(self.lut_frac_bits)


FP32 = QatPolicy(enabled=False)
EDGEDRNN_QAT = QatPolicy()  # INT8 weights / INT16 acts / Q1.4 LUT
EDGEDRNN_QAT_W4 = QatPolicy.for_weight_bits(4)  # INT4 weights (fused_q4)
