"""Compiled DeltaRNN programs: compile once, stream forever. The PyTorch port
of :mod:`repro.core.program`.

:func:`compile_delta_program` resolves a
:class:`~repro_torch.core.backends.BackendSpec` from the registry, packs
every layer's weights once (quantizing them for ``fused_q8`` /
``fused_q4``) on the CPU, moves the program to its device and returns an
immutable :class:`DeltaProgram`. States come only from
:meth:`DeltaProgram.init_state`, which bakes in the backend's delta-memory
convention; :meth:`DeltaProgram.step` / :meth:`DeltaProgram.sequence`
check that a state was minted by a same-cell, same-backend program.

Typical use::

    prog = compile_deltagru(params, backend="fused_q8")   # on the card
    state = prog.init_state(batch_shape=(n_streams,))
    y, state, deltas = prog.step(state, x, theta_x, theta_h)
    logits = prog.apply_head(y)

or hand the program to :class:`repro_torch.serve.engine.DeltaStreamEngine`.
All four cell families of the JAX package compile the same way:
``cell="lstm"`` an ``init_lstm_model`` dict, ``cell="rwkv6"`` an
``init_deltarwkv_model`` dict and ``cell="rglru"`` an
``init_deltarglru_model`` dict.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core.backends import BackendSpec, get_backend
from repro_torch.kernels.ops import resolve_device


def _cell_ops(cell: str) -> dict:
    """Per-cell stack drivers (init / step / sequence)."""
    if cell == "gru":
        from repro_torch.core import deltagru as m
        return {"init": m.init_deltagru_stack_state,
                "step": m.deltagru_stack_step,
                "sequence": m.deltagru_sequence,
                "params_key": "gru"}
    if cell == "lstm":
        from repro_torch.core import deltalstm as m
        return {"init": m.init_deltalstm_stack_state,
                "step": m.deltalstm_stack_step,
                "sequence": m.deltalstm_sequence,
                "params_key": "lstm"}
    if cell == "rwkv6":
        from repro_torch.core import deltarwkv as m
        return {"init": m.init_deltarwkv_stack_state,
                "step": m.deltarwkv_stack_step,
                "sequence": m.deltarwkv_sequence,
                "params_key": "rwkv6"}
    if cell == "rglru":
        from repro_torch.core import deltarglru as m
        return {"init": m.init_deltarglru_stack_state,
                "step": m.deltarglru_stack_step,
                "sequence": m.deltarglru_sequence,
                "params_key": "rglru"}
    raise ValueError(f"unknown cell family {cell!r}; known: "
                     f"('gru', 'lstm', 'rwkv6', 'rglru')")


@dataclass(frozen=True)
class DeltaProgramState:
    """A delta-RNN stack state minted by (and bound to) a compiled program:
    the raw stack state plus the backend and cell names it was built for.
    Construct via :meth:`DeltaProgram.init_state`, never directly."""

    stack: object
    backend: str
    cell: str = "gru"

    @property
    def layers(self) -> tuple:
        return self.stack.layers


@dataclass(frozen=True)
class DeltaProgram:
    """An immutable, ready-to-run delta-RNN stack for one (cell, backend).

    Holds the per-layer parameters (the dequantized fake-quant view for
    ``fused_q8`` / ``fused_q4``), the pre-packed kernel layouts, an
    optional classifier head and the backend name, all on one device.
    Build with :func:`compile_delta_program`; do not construct directly.
    """

    layers: tuple
    layouts: tuple | None
    head: torch.Tensor | None
    head_b: torch.Tensor | None
    backend: str
    cell: str = "gru"

    # -- derived ----------------------------------------------------------

    @property
    def spec(self) -> BackendSpec:
        return get_backend(self.backend, cell=self.cell)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def input_size(self) -> int:
        return self.layers[0].input_size

    @property
    def hidden_size(self) -> int:
        return self.layers[-1].hidden_size

    @property
    def device(self) -> torch.device:
        return self.layers[0][0].device     # the first tensor of a layer

    # -- states -----------------------------------------------------------

    def init_state(self, batch_shape=(), dtype=None) -> DeltaProgramState:
        """A fresh stack state under this backend's ``m_init`` convention,
        on the program's device."""
        stack = _cell_ops(self.cell)["init"](self.layers, batch_shape, dtype,
                                             m_init=self.spec.m_init)
        return DeltaProgramState(stack=stack, backend=self.backend,
                                 cell=self.cell)

    def check_state(self, state) -> None:
        """Raise unless ``state`` was minted by a same-cell, same-backend
        program."""
        if not isinstance(state, DeltaProgramState):
            raise TypeError(
                "expected a DeltaProgramState from program.init_state(); "
                f"got {type(state).__name__} — raw stack states carry no "
                "m_init convention tag and cannot be safely executed")
        if state.cell != self.cell:
            raise ValueError(
                f"state was built for cell {state.cell!r} but this program "
                f"runs {self.cell!r}; rebuild with program.init_state()")
        if state.backend != self.backend:
            raise ValueError(
                f"state was built for backend {state.backend!r} "
                f"(m_init={get_backend(state.backend, self.cell).m_init!r}) "
                f"but this program runs {self.backend!r} "
                f"(m_init={self.spec.m_init!r}); feeding it through would "
                "silently corrupt the delta memories — rebuild with "
                "program.init_state()")

    # -- execution --------------------------------------------------------

    def step(self, state: DeltaProgramState, x: torch.Tensor,
             theta_x=0.0, theta_h=0.0, guard=None):
        """One timestep through all layers: ``(y, new_state, deltas)`` with
        ``deltas`` the per-layer sparse ``(delta_x, delta_h)`` pairs.
        ``guard`` (a :class:`repro_torch.kernels.delta_unit.FrameGuard`, on
        a backend whose spec has ``frame_guard``): ``x`` is the raw frame,
        guarded by layer 0's Delta Unit launch."""
        self.check_state(state)
        guarded = {} if guard is None else {"guard": guard}
        y, stack, deltas = _cell_ops(self.cell)["step"](
            self.layers, state.stack, x, theta_x, theta_h,
            backend=self.backend, layouts=self.layouts, **guarded)
        return y, DeltaProgramState(stack=stack, backend=self.backend,
                                    cell=self.cell), deltas

    def sequence(self, xs: torch.Tensor, theta_x=0.0, theta_h=0.0,
                 init_state: DeltaProgramState | None = None,
                 collect_sparsity: bool = True):
        """Run the program over ``xs: [T, B, I]``; returns
        ``(ys, final_state, stats)``."""
        if init_state is None:
            init_state = self.init_state(xs.shape[1:-1], xs.dtype)
        self.check_state(init_state)
        ys, final, stats = _cell_ops(self.cell)["sequence"](
            self.layers, xs, theta_x, theta_h,
            init_state=init_state.stack, collect_sparsity=collect_sparsity,
            backend=self.backend, layouts=self.layouts)
        return ys, DeltaProgramState(stack=final, backend=self.backend,
                                     cell=self.cell), stats

    def apply_head(self, ys: torch.Tensor) -> torch.Tensor:
        """Apply the compiled classifier/regression head."""
        if self.head is None:
            raise ValueError("program was compiled from a bare layer stack; "
                             "compile from a model params dict to carry "
                             "the head")
        return ys @ self.head + self.head_b

    def with_backend(self, backend: str) -> "DeltaProgram":
        """Same packed weights, another pack-compatible backend (the
        per-stream <-> ``*_batch`` pairs share pack fn and ``m_init``)."""
        if backend == self.backend:
            return self
        new = get_backend(backend, cell=self.cell)
        cur = self.spec
        if new.pack is not cur.pack or new.m_init != cur.m_init:
            raise ValueError(
                f"backend {backend!r} packs weights differently from "
                f"{self.backend!r} (pack/m_init mismatch); the compiled "
                "layouts cannot be reused — recompile with "
                "compile_delta_program(params, backend=...)")
        return replace(self, backend=backend)

    def to(self, device) -> "DeltaProgram":
        """The same program with every tensor copied to ``device`` (itself
        when it is already there); the packed bytes are copied as they
        are."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return replace(
            self, layers=tuple(p.to(dev) for p in self.layers),
            layouts=(tuple(_to(lay, dev) for lay in self.layouts)
                     if self.layouts is not None else None),
            head=_to(self.head, dev), head_b=_to(self.head_b, dev))


def infer_cell(params) -> str:
    """Cell family of a model params dict (stack-key spelling)."""
    if isinstance(params, dict):
        for cell in ("lstm", "rwkv6", "rglru"):
            if cell in params:
                return cell
        if "gru" in params:
            return "gru"
    return "gru"


def _to(obj, device):
    return obj.to(device) if obj is not None else None


def compile_delta_program(params, backend: str = "fused", *,
                          cell: str = "gru", layouts=None,
                          block: int = 128, device=None) -> DeltaProgram:
    """Compile a delta-RNN stack (or model dict) into a program.

    Args:
      params: a sequence of per-layer params
        (:class:`~repro_torch.core.deltagru.GruLayerParams` /
        :class:`~repro_torch.core.deltalstm.LstmLayerParams`,
        :class:`~repro_torch.core.deltarwkv.RwkvLayerParams`,
        :class:`~repro_torch.core.deltarglru.RglruLayerParams`) or a model
        params dict (``{"gru" | "lstm" | "rwkv6" | "rglru", "head",
        "head_b"}``; the head is carried).
      backend: any backend name registered for ``cell``.
      cell: the cell family (``"gru"``, ``"lstm"``, ``"rwkv6"`` or
        ``"rglru"``).
      layouts: optional pre-packed per-layer kernel layouts.
      block: kernel block size used when packing.
      device: where the program runs; default ``"cuda"``, and without a
        card this raises unless ``device="cpu"`` is given.
    """
    dev = resolve_device(device)
    ops = _cell_ops(cell)
    spec = get_backend(backend, cell=cell)
    head = head_b = None
    if isinstance(params, dict):
        head, head_b = params.get("head"), params.get("head_b")
        key = ops["params_key"]
        if key not in params:
            raise ValueError(
                f"cell={cell!r} programs compile from a {key!r} stack; the "
                f"params dict has keys {sorted(params)} — pass cell="
                f"{infer_cell(params)!r} or the matching stack")
        stack = list(params[key])
    else:
        stack = list(params)
    if not stack or not isinstance(stack[0], tuple):
        raise TypeError(f"compile_delta_program needs a non-empty {cell} "
                        f"layer-params stack; got {type(params).__name__}")
    # Pack on the CPU (device-independent bytes), then move to the device.
    stack = [p.to("cpu") for p in stack]
    if layouts is None:
        stack, layouts = spec.pack(stack, block)
    return DeltaProgram(
        layers=tuple(p.to(dev) for p in stack),
        layouts=(tuple(_to(l, dev) for l in layouts)
                 if layouts is not None else None),
        head=_to(head, dev), head_b=_to(head_b, dev), backend=backend,
        cell=cell)


# the GRU-pinned names of the JAX package: the same classes
DeltaGruProgram = DeltaProgram
DeltaGruProgramState = DeltaProgramState


def compile_deltagru(params, backend: str = "fused", *, layouts=None,
                     block: int = 128, device=None) -> DeltaProgram:
    """GRU-pinned alias of :func:`compile_delta_program`."""
    return compile_delta_program(params, backend, cell="gru",
                                 layouts=layouts, block=block,
                                 device=device)
