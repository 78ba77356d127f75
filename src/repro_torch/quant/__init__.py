"""Fixed-point grids, LUT nonlinearities and the int8 / int4 exporter: the
public names of :mod:`repro.quant`, re-exported."""
from repro_torch.quant.export import (quantize_delta_model,
                                      quantize_delta_stack,
                                      quantize_gru_model, quantize_stack)
from repro_torch.quant.fake_quant import (QFormat, dequantize, fake_quant,
                                          quantize)
from repro_torch.quant.lut import LutNonlinearity, lut_sigmoid, lut_tanh

__all__ = ["QFormat", "fake_quant", "quantize", "dequantize",
           "LutNonlinearity", "lut_sigmoid", "lut_tanh",
           "quantize_delta_stack", "quantize_delta_model",
           "quantize_stack", "quantize_gru_model"]
