"""Shared model initializers, the part of :mod:`repro.models.common` the
GRU models need (the port keeps its own copy)."""
from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (at ±2σ) fan-in init, drawn on the CPU."""
    std = scale if scale is not None else in_dim ** -0.5
    w = torch.empty((in_dim, out_dim), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)
