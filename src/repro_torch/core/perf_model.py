"""EdgeDRNN analytical performance model (paper Eqs. 5-8), the PyTorch port
of :mod:`repro.core.perf_model`.

* Eq. 5 — Delta Unit latency ``tau_DU``.
* Eq. 6 — bandwidth-matched PE count ``K = W_DRAM / W_weight`` and peak
  throughput ``nu_peak = 2 * f_pl * K``.
* Eq. 7 — mean effective throughput of a stack at measured sparsity.
* Eq. 8 — memory-bounded peak and sparsity-normalized batch-1 throughput.

These are models of the paper's FPGA (``AcceleratorSpec``: 125 MHz, a
64-bit DRAM weight bus). The latencies they give — and that the streaming
engine reports as ``mean_est_latency_us`` — are that accelerator's modelled
times, not times measured on any GPU. The functions are plain arithmetic,
so they take Python floats or tensors alike (the engine accumulates them on
the device without a host sync).

The JAX package's TPU v5e constants (``TpuChipSpec``) are not ported: no
code on this path needs them, and when the roofline harness is ported its
constants will be the H100's, measured, never the v5e's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

from repro_torch.core.sparsity import GruDims, effective_sparsity


@dataclass(frozen=True)
class AcceleratorSpec:
    """An EdgeDRNN-style bandwidth-matched accelerator."""

    f_pl_hz: float = 125e6       # programmable-logic clock
    dram_bits: int = 64          # DRAM interface width for weight fetch
    w_weight_bits: int = 8       # weight precision
    w_index_bits: int = 0        # nonzero-index overhead (0 for delta nets)
    n_delta_units: int = 1       # N in Eq. 5
    lookahead: int = 1           # d in Eq. 5

    @property
    def k_pes(self) -> int:
        """Eq. 6: number of PEs that exactly saturates the DRAM interface."""
        return self.dram_bits // self.w_weight_bits

    @property
    def peak_ops(self) -> float:
        """Eq. 6: theoretical peak throughput in Op/s (1 MAC = 2 Op)."""
        return 2.0 * self.f_pl_hz * self.k_pes

    @property
    def mem_bounded_peak_ops(self) -> float:
        """Eq. 8: memory-bounded peak throughput including index overhead."""
        eff_lanes = self.dram_bits / (self.w_weight_bits + self.w_index_bits)
        return 2.0 * self.f_pl_hz * eff_lanes


EDGEDRNN = AcceleratorSpec()


def backend_weight_bits(cell: str = "gru") -> dict:
    """Streamed weight width of every registered backend of a cell."""
    from repro_torch.core.backends import registered_backends
    return {s.name: s.weight_bits for s in registered_backends(cell)}


def spec_for_backend(spec: AcceleratorSpec, backend: str,
                     cell: str = "gru") -> AcceleratorSpec:
    """The spec whose weight-stream width matches a backend (unknown names
    raise through the registry)."""
    from repro_torch.core.backends import get_backend
    return replace(spec, w_weight_bits=get_backend(backend, cell).weight_bits)


def delta_unit_latency_cycles(vec_len: int, gamma: float,
                              spec: AcceleratorSpec = EDGEDRNN) -> int:
    """Eq. 5: cycles for the Delta Unit(s) to encode a vector."""
    n, d = spec.n_delta_units, spec.lookahead
    return max(math.ceil(vec_len / (n * d)), math.ceil(vec_len * (1.0 - gamma)))


@dataclass(frozen=True)
class StackEstimate:
    ops_per_timestep: int
    effective_macs: float
    latency_s: float
    throughput_ops: float
    gamma_eff: float


def stack_effective_macs(dims: GruDims, gamma_dx, gamma_dh):
    """Eq. 7 numerator: MACs that survive delta skipping."""
    in_block = dims.x_weight_volume    # gated by delta-x
    rec_block = dims.h_weight_volume   # gated by delta-h
    return in_block * (1.0 - gamma_dx) + rec_block * (1.0 - gamma_dh)


def stack_latency_s(dims: GruDims, gamma_dx, gamma_dh,
                    spec: AcceleratorSpec = EDGEDRNN):
    """Eq. 7 latency: surviving MACs at ``K`` MACs/cycle."""
    return stack_effective_macs(dims, gamma_dx, gamma_dh) / (
        spec.k_pes * spec.f_pl_hz)


def estimate_stack(dims: GruDims, gamma_dx: float, gamma_dh: float,
                   spec: AcceleratorSpec = EDGEDRNN) -> StackEstimate:
    """Eq. 7: estimated latency / mean effective throughput of a stack.
    A fully silent stack reports infinite throughput."""
    macs = stack_effective_macs(dims, gamma_dx, gamma_dh)
    latency = stack_latency_s(dims, gamma_dx, gamma_dh, spec)
    ops = dims.params_per_timestep_ops
    return StackEstimate(
        ops_per_timestep=ops,
        effective_macs=macs,
        latency_s=latency,
        throughput_ops=ops / latency if latency > 0 else float("inf"),
        gamma_eff=effective_sparsity(dims, gamma_dx, gamma_dh),
    )


def normalized_batch1_throughput(gamma_eff: float,
                                 w_index_bits: int,
                                 spec: AcceleratorSpec = EDGEDRNN) -> float:
    """Eq. 8 upper bound used in Table VI."""
    norm = AcceleratorSpec(f_pl_hz=spec.f_pl_hz, dram_bits=spec.dram_bits,
                           w_weight_bits=spec.w_weight_bits,
                           w_index_bits=w_index_bits)
    return norm.mem_bounded_peak_ops / (1.0 - gamma_eff)


def dram_traffic_bytes_per_timestep(dims: GruDims, gamma_dx, gamma_dh,
                                    w_weight_bits: int = 8):
    """Weight bytes fetched per timestep after delta column skipping."""
    surviving = (dims.x_weight_volume * (1.0 - gamma_dx)
                 + dims.h_weight_volume * (1.0 - gamma_dh))
    return surviving * w_weight_bits / 8.0


def union_sparsity(gamma, batch: int):
    """Sparsity surviving a union over ``batch`` independent streams: a
    column is skipped only when every stream kept it silent, ``gamma**B``."""
    return gamma ** batch


def tile_dram_traffic_bytes_per_timestep(dims: GruDims, gamma_dx_union,
                                         gamma_dh_union,
                                         w_weight_bits: int = 8):
    """Eq. 7 bytes of a batched tile: one fetch per ``[B, ...]`` tile at
    the union gammas."""
    return dram_traffic_bytes_per_timestep(dims, gamma_dx_union,
                                           gamma_dh_union, w_weight_bits)


def estimate_batched_tile(dims: GruDims, gamma_dx: float, gamma_dh: float,
                          batch: int,
                          spec: AcceleratorSpec = EDGEDRNN) -> dict:
    """Analytic batched bytes/op pricing from per-stream gammas."""
    gx_u = union_sparsity(gamma_dx, batch)
    gh_u = union_sparsity(gamma_dh, batch)
    lat = stack_latency_s(dims, gx_u, gh_u, spec)
    tile_bytes = tile_dram_traffic_bytes_per_timestep(
        dims, gx_u, gh_u, w_weight_bits=spec.w_weight_bits)
    ops = dims.params_per_timestep_ops * batch
    return {
        "batch": batch,
        "gamma_dx_union": gx_u,
        "gamma_dh_union": gh_u,
        "tile_latency_s": lat,
        "tile_weight_bytes": tile_bytes,
        "weight_bytes_per_stream": tile_bytes / batch,
        "throughput_ops": ops / lat if lat > 0 else float("inf"),
    }
