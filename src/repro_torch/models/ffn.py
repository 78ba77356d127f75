"""Feed-forward blocks: gated (SwiGLU / GeGLU) and plain MLPs, the PyTorch
port of :mod:`repro.models.ffn`."""
from __future__ import annotations

import torch

from repro_torch.models.common import ACTIVATIONS, dense_init


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(generator, d_model, d_ff, dtype),
         "w_down": dense_init(generator, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype)
    return p


def ffn_apply(params: dict, x: torch.Tensor, *,
              activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    up = x @ params["w_up"]
    h = act(x @ params["w_gate"]) * up if "w_gate" in params else act(up)
    return h @ params["w_down"]
