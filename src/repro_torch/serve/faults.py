"""Deterministic fault injection for the resilient serving tier, the
PyTorch port of :mod:`repro.serve.faults`.

Everything here is seeded: a :class:`FaultPlan` maps ``(seed, stream
index, tick)`` to faults with no ambient randomness (numpy's
``default_rng``, drawn exactly as the JAX package draws), so a chaos soak
run twice, or once in each package, produces the same fault schedule and
its recovery counts can be asserted exactly.

Fault classes:

* **poisoned frames**: NaN/Inf components in the input stream (sensor
  glitch, DMA underrun), injected by :meth:`FaultPlan.poison_stream` and
  neutralised on the device by the engine's frame guard;
* **slot-state corruption**: non-finite values written into one stream's
  recurrent state (:func:`corrupt_slot_state`, the stand-in for a bit
  flip in on-chip memory), detected by the engine's ``bad_state`` counter
  and repaired by snapshot rollback;
* **stalled ticks**: the serve loop blocks (CPU contention), surfaced by
  heartbeat age and straggler flags;
* **simulated crash**: :class:`SimulatedCrash` raised at a planned tick;
  :func:`repro_torch.serve.resilience.serve_resumable` restarts from the
  published checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.engine import _leaves


class SimulatedCrash(RuntimeError):
    """An injected process death (preemption / power loss / OOM-kill)."""


def sanitize_frames(frames: np.ndarray) -> np.ndarray:
    """Replace non-finite frames (whole rows) with the previous finite
    frame: the engine guard's zero-delta semantics, applied on the host. A
    bad frame 0 falls back to zeros (the delta-memory init convention,
    still the silent regime). Returns a new array."""
    frames = np.array(frames, np.float32)
    good = np.isfinite(frames).all(axis=-1)
    last = np.zeros((frames.shape[-1],), np.float32)
    for t in range(frames.shape[0]):
        if good[t]:
            last = frames[t]
        else:
            frames[t] = last
    return frames


def corrupt_slot_state(engine, sid: int):
    """Write NaN into every float leaf of one stream slot's stack state.

    The write goes into the engine's live state buffers in place (a fill
    of the slot's rows, device work only, no host sync), so the next step,
    a replay of the engine's CUDA graph on the card, reads it and flags
    the slot in ``bad_state``. Companion slots and non-float leaves are
    untouched.
    """
    if not (0 <= sid < engine.n_streams):
        raise ValueError(f"stream {sid} out of range")
    for leaf in _leaves(engine.state.stack):
        if leaf.is_floating_point():
            leaf[sid].fill_(float("nan"))


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative chaos schedule.

    ``poison_streams`` / ``inf_streams``: stream (arrival) indices whose
    frame sequences get ``poison_frames`` NaN / Inf frames each, at
    positions drawn from ``default_rng(seed * 1000 + index)``: reproducible
    per stream, independent of arrival order.

    ``corrupt_slot_at``: ``((tick, sid), ...)`` direct state-corruption
    events. ``stall_ticks``: ticks on which the harness sleeps
    ``stall_s``. ``crash_at_tick``: raise :class:`SimulatedCrash` once at
    that tick (the restarted loop passes it unharmed, like a real
    transient fault).
    """

    seed: int = 0
    poison_streams: tuple = ()
    inf_streams: tuple = ()
    poison_frames: int = 2
    corrupt_slot_at: tuple = ()
    stall_ticks: tuple = ()
    stall_s: float = 0.05
    crash_at_tick: int | None = None
    _crash_fired: list = field(default_factory=list, repr=False,
                               compare=False)

    def poison_stream(self, index: int, frames: np.ndarray) -> np.ndarray:
        """A poisoned copy of ``frames`` if stream ``index`` is in the
        plan, else ``frames`` unchanged."""
        kind = (np.nan if index in self.poison_streams
                else np.inf if index in self.inf_streams else None)
        if kind is None:
            return frames
        frames = np.array(frames, np.float32)
        rng = np.random.default_rng(self.seed * 1000 + index)
        t_idx = rng.choice(frames.shape[0],
                           size=min(self.poison_frames, frames.shape[0]),
                           replace=False)
        c_idx = rng.integers(0, frames.shape[1], size=len(t_idx))
        frames[t_idx, c_idx] = kind
        return frames

    def corruptions(self, tick: int) -> list:
        """Slot ids to corrupt at ``tick``."""
        return [sid for t, sid in self.corrupt_slot_at if t == tick]

    def is_stall(self, tick: int) -> bool:
        return tick in self.stall_ticks

    def maybe_crash(self, tick: int):
        """Raise :class:`SimulatedCrash` at the planned tick, once."""
        if (self.crash_at_tick is not None and tick == self.crash_at_tick
                and not self._crash_fired):
            self._crash_fired.append(tick)
            raise SimulatedCrash(f"injected crash at tick {tick}")
