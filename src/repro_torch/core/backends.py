"""Execution-backend registry for delta-RNN cells, the PyTorch port of
:mod:`repro.core.backends`.

A :class:`BackendSpec` captures how a layer's weights are packed for the
kernel (``pack``), how one timestep executes (``step``), which delta-memory
init convention its state uses (``m_init``), the weight width it streams
(``weight_bits``, priced by the Eq. 6/7 model), and whether one weight
fetch serves one stream or a whole stream tile (``weight_fetch``).

The registry is keyed on ``(cell, name)``. Each cell family's backends
register when its module imports: :mod:`repro_torch.core.deltagru`
(``"gru"``), :mod:`repro_torch.core.deltalstm` (``"lstm"``),
:mod:`repro_torch.core.deltarwkv` (``"rwkv6"``) and
:mod:`repro_torch.core.deltarglru` (``"rglru"``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

# (cell, name) -> BackendSpec
_REGISTRY: dict = {}


@dataclass(frozen=True)
class BackendSpec:
    """One execution path for a delta-RNN cell.

    Attributes:
      name: registry key (``"dense" | "fused" | "fused_batch" | ...``).
      pack: ``pack(layer_params, block) -> (layers, layouts)``.
      step: one timestep::

          step(params, state, x, theta_x, theta_h, *, layout)
              -> DeltaGruStepOut / DeltaLstmStepOut

        The GRU and LSTM steps also take ``sigmoid=`` / ``tanh=``
        (default ``torch.sigmoid`` / ``torch.tanh``); only ``dense``
        honours other functions, every kernel backend raises on them.

      cell: recurrent cell family.
      m_init: ``"bias"`` folds biases into M; ``"zero"`` is the unscaled
        code-domain accumulator whose bias lives in the packed layout.
      weight_bits: width of one streamed weight in bits.
      weight_fetch: ``"stream"`` (one fetch per stream per step) or
        ``"tile"`` (one fetch per ``[B, ...]`` stream tile, compacted on
        the union of fired columns).
    """

    name: str
    pack: Callable
    step: Callable
    cell: str = "gru"
    m_init: str = "bias"
    weight_bits: int = 32
    weight_fetch: str = "stream"


def register_backend(spec: BackendSpec) -> BackendSpec:
    """Register a backend spec; duplicate ``(cell, name)`` keys are an error."""
    key = (spec.cell, spec.name)
    if key in _REGISTRY:
        raise ValueError(
            f"backend {spec.name!r} is already registered for cell "
            f"{spec.cell!r}; pick a new name or unregister the old spec")
    _REGISTRY[key] = spec
    return spec


def unregister_backend(name: str, cell: str = "gru") -> None:
    """Remove a spec (tests / experimental backends)."""
    _REGISTRY.pop((cell, name), None)


def _ensure_builtins() -> None:
    """Import the builtin cell modules so their specs self-register."""
    import repro_torch.core.deltagru  # noqa: F401  (registers gru backends)
    import repro_torch.core.deltalstm  # noqa: F401  (registers lstm backends)
    import repro_torch.core.deltarglru  # noqa: F401  (registers rglru backends)
    import repro_torch.core.deltarwkv  # noqa: F401  (registers rwkv6 backends)


def require_stream_tile(x, name: str) -> None:
    """Tile-contract guard for the ``*_batch`` backends: their inputs must
    carry an explicit leading stream axis (``[B, ..., I]``)."""
    if getattr(x, "ndim", 0) < 2:
        raise ValueError(
            f"{name} computes a [B, ...] tile of streams per step (one "
            f"weight pass serves the whole tile); got a {getattr(x, 'ndim', 0)}-D "
            f"input — add a leading stream axis, or use the per-stream "
            f"{name.removesuffix('_batch')!r} backend")


def require_default_acts(sigmoid: Callable, tanh: Callable,
                         message: str) -> None:
    """Guard of the kernel backends: they hard-code their activation
    pipeline, so custom (QAT) ``sigmoid`` / ``tanh`` raise ``ValueError``
    with ``message`` rather than run another path."""
    if not (sigmoid is torch.sigmoid and tanh is torch.tanh):
        raise ValueError(message)


def quant_acts_message(name: str) -> str:
    """The refusal of the int8 / int4 backends ``fused_q8`` / ``fused_q4``."""
    return (f"{name} hard-codes the Q8.8/Q1.n LUT activation pipeline; "
            "pass backend='dense' with QAT act fns for training-time "
            "emulation")


def batched_step(name: str, parent: Callable) -> Callable:
    """The ``*_batch`` tile contract over a per-stream step: require the
    stream axis, then run the same kernel (it already compacts on the union
    of fired columns across the tile, and a stream that did not fire a
    fired block adds exact zeros)."""
    def step(params, state, x, theta_x, theta_h, *, layout, **acts):
        require_stream_tile(x, name)
        return parent(params, state, x, theta_x, theta_h, layout=layout,
                      **acts)
    step.__name__ = f"_step_{name}"
    return step


# (cell, name) -> replacement: backends that were deliberately retired.
REMOVED_BACKENDS = {
    ("gru", "blocksparse"): "fused",
}


def get_backend(name: str, cell: str = "gru") -> BackendSpec:
    """Look up a registered spec; unknown names raise with the known set,
    retired ones name their replacement."""
    _ensure_builtins()
    spec = _REGISTRY.get((cell, name))
    if spec is None:
        repl = REMOVED_BACKENDS.get((cell, name))
        if repl is not None:
            raise ValueError(
                f"{cell} backend {name!r} was removed; use {repl!r} "
                f"instead (same math, one fused kernel launch per layer "
                f"step instead of two separately-compacted spmv calls)")
        known = list_backends(cell)
        raise ValueError(
            f"unknown {cell} backend {name!r}; registered backends: {known}")
    return spec


def list_backends(cell: str = "gru") -> tuple:
    """Registered backend names for a cell, in registration order."""
    _ensure_builtins()
    return tuple(n for (c, n) in _REGISTRY if c == cell)


# the JAX package's other name for list_backends
backend_names = list_backends


def registered_backends(cell: str = "gru") -> tuple:
    """All registered specs for a cell, in registration order."""
    _ensure_builtins()
    return tuple(s for (c, _), s in _REGISTRY.items() if c == cell)
