"""Temporal-sparsity metrics (EdgeDRNN Eq. 4), stack dimensions and op
counting (Eq. 7 numerator), the PyTorch port of :mod:`repro.core.sparsity`.

``Gamma`` (Γ) is the fraction of zeros in delta vectors; the effective
sparsity weights Γ_Δx and Γ_Δh by the number of parameters each gates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

# Rows of the RWKV6 decay LoRA down-projection (repro.core.deltarwkv).
DECAY_LORA = 64


@dataclass(frozen=True)
class GruDims:
    """Dimensions of an L-layer delta-RNN stack (uniform hidden size).

    ``gates`` is the number of stacked gate rows per weight column (3 for
    GRU, 4 for LSTM). Cells whose gated projections are not gate rows over
    ``[I+H]`` columns pass the gated volumes as ``x_weights`` /
    ``h_weights`` (stack totals).
    """

    input_size: int   # I
    hidden_size: int  # H
    num_layers: int   # L
    gates: int = 3
    x_weights: int | None = None
    h_weights: int | None = None

    @property
    def x_weight_volume(self) -> int:
        """Parameters gated by the Δx streams: ``gHI + gH^2(L-1)``."""
        if self.x_weights is not None:
            return self.x_weights
        i, h, l, g = (self.input_size, self.hidden_size, self.num_layers,
                      self.gates)
        return g * h * i + g * h * h * (l - 1)

    @property
    def h_weight_volume(self) -> int:
        """Parameters gated by the Δh streams: ``gH^2 L``."""
        if self.h_weights is not None:
            return self.h_weights
        h, l, g = self.hidden_size, self.num_layers, self.gates
        return g * h * h * l

    @property
    def params_per_timestep_ops(self) -> int:
        """Eq. 7 'Op': 2 * (x_weight_volume + h_weight_volume)."""
        return 2 * (self.x_weight_volume + self.h_weight_volume)

    @property
    def n_params(self) -> int:
        """Delta-gated weight parameter count (biases excluded)."""
        return self.x_weight_volume + self.h_weight_volume


# Gate rows per weight column, per cell family.
CELL_GATES = {"gru": 3, "lstm": 4}


def _rwkv6_volumes(i: int, h: int, l: int) -> tuple[int, int]:
    """RWKV6 time-mix volumes: 3·D² (W_r/W_k/W_v) and D·DECAY_LORA per layer."""
    return 3 * h * h * l, h * DECAY_LORA * l


def _rglru_volumes(i: int, h: int, l: int) -> tuple[int, int]:
    """RG-LRU volumes: 2·D·W (w_in, w_in_gate) and 2·W² (w_rg, w_ig) per layer."""
    return 2 * i * h * l, 2 * h * h * l


# Cell families priced by explicit projection volumes rather than gate rows.
CELL_PROJ_VOLUMES = {"rwkv6": _rwkv6_volumes, "rglru": _rglru_volumes}


def cell_dims(cell: str, input_size: int, hidden_size: int,
              num_layers: int) -> GruDims:
    """Dims of an L-layer delta-RNN stack of the given cell family."""
    if cell in CELL_GATES:
        return GruDims(input_size, hidden_size, num_layers,
                       gates=CELL_GATES[cell])
    if cell in CELL_PROJ_VOLUMES:
        xw, hw = CELL_PROJ_VOLUMES[cell](input_size, hidden_size, num_layers)
        return GruDims(input_size, hidden_size, num_layers, gates=1,
                       x_weights=xw, h_weights=hw)
    raise ValueError(f"unknown cell family {cell!r}; known gate "
                     f"counts: {CELL_GATES}, known projection-volume "
                     f"cells: {sorted(CELL_PROJ_VOLUMES)}")


def lstm_dims(input_size: int, hidden_size: int, num_layers: int) -> GruDims:
    """Dims of an L-layer (Delta)LSTM stack: the 4-gate weight volume."""
    return cell_dims("lstm", input_size, hidden_size, num_layers)


def effective_sparsity(dims: GruDims, gamma_dx: float, gamma_dh: float) -> float:
    """Eq. 4 Γ_eff: parameter-weighted average of input/hidden sparsity."""
    if dims.x_weights is None and dims.h_weights is None:
        i, h, l = dims.input_size, dims.hidden_size, dims.num_layers
        num = (i + h * (l - 1)) * gamma_dx + h * l * gamma_dh
        den = i + h * (l - 1) + h * l
        return num / den
    xw, hw = dims.x_weight_volume, dims.h_weight_volume
    return (xw * gamma_dx + hw * gamma_dh) / (xw + hw)



def recip_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean as a sum times the reciprocal of the count. CUDA divides a
    tensor by a Python scalar through its reciprocal, the CPU divides;
    written out this way (as XLA compiles the JAX package's means) a mean
    rounds alike on both devices and in both packages."""
    n = x.numel() if dim is None else x.shape[dim]
    total = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    return total * (1.0 / n)


def fraction_zeros(x: torch.Tensor) -> torch.Tensor:
    """Fraction of exactly-zero elements (a delta that fired is a.s.
    nonzero)."""
    return recip_mean((x == 0).to(torch.float32))


def gamma_from_fired(fired: torch.Tensor) -> torch.Tensor:
    """Sparsity from a boolean 'fired' mask: Γ = mean(!fired)."""
    return 1.0 - recip_mean(fired.to(torch.float32))


def measure_layer_sparsity(delta_x: torch.Tensor, delta_h: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Measured (Γ_Δx, Γ_Δh) for one layer over a [T, ...] delta
    sequence."""
    return fraction_zeros(delta_x), fraction_zeros(delta_h)


def stack_sparsity(per_layer_dx: Sequence, per_layer_dh: Sequence
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregate per-layer Γ into stack-level Γ_Δx / Γ_Δh (Eq. 4
    averages)."""
    gdx = recip_mean(torch.stack([torch.as_tensor(g, dtype=torch.float32)
                                  for g in per_layer_dx]))
    gdh = recip_mean(torch.stack([torch.as_tensor(g, dtype=torch.float32)
                                  for g in per_layer_dh]))
    return gdx, gdh
