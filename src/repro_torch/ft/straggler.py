"""Straggler detection + mitigation policy, the port of
:mod:`repro.ft.straggler` (pure Python, the same as there).

Detection: per-worker step-time EWMA; a worker is a straggler when its step
time exceeds ``factor`` x the fleet median for ``patience`` consecutive
steps (robust to one-off GC/compilation pauses — exactly the CPU-contention
tail the paper measured in its PetaLinux Table IV study).

Mitigation policies:
* ``"wait"``     — do nothing (synchronous SGD default).
* ``"drop"``     — exclude the straggler's DP shard this step and rescale
                   the gradient sum by N/(N-k) (bounded staleness).
* ``"restart"``  — flag for the restart manager (persistent stragglers).
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass


@dataclass
class StragglerReport:
    stragglers: list
    median_s: float
    worst_ratio: float
    action: str


class StragglerDetector:
    def __init__(self, factor: float = 2.0, patience: int = 3,
                 ewma: float = 0.5, policy: str = "drop"):
        self.factor = factor
        self.patience = patience
        self.ewma = ewma
        self.policy = policy
        self._t: dict[str, float] = {}
        self._strikes: dict[str, int] = {}

    def observe(self, step_times: dict[str, float]) -> StragglerReport:
        for w, t in step_times.items():
            prev = self._t.get(w)
            self._t[w] = t if prev is None else (
                self.ewma * t + (1 - self.ewma) * prev)
        med = statistics.median(self._t.values())
        stragglers = []
        worst = 1.0
        for w, t in self._t.items():
            ratio = t / max(med, 1e-9)
            worst = max(worst, ratio)
            if ratio > self.factor:
                self._strikes[w] = self._strikes.get(w, 0) + 1
                if self._strikes[w] >= self.patience:
                    stragglers.append(w)
            else:
                self._strikes[w] = 0
        action = self.policy if stragglers else "none"
        return StragglerReport(stragglers, med, worst, action)

    def observe_solo(self, worker: str, step_s: float,
                     ref_s: float) -> StragglerReport:
        """Single-pipeline convenience (the serving tier has one loop, not
        a fleet): compare ``worker``'s step time to a reference wall (e.g.
        the best tick observed so far) instead of a fleet median. Two
        phantom reference entries pin the median at ``ref_s``, so the
        standard factor/patience machinery applies unchanged — a serve
        tick that blows past ``factor`` x its own best for ``patience``
        consecutive ticks is flagged exactly like a fleet straggler.
        """
        return self.observe({worker: step_s, "_ref0": ref_s,
                             "_ref1": ref_s})

    @staticmethod
    def rescale_factor(n_workers: int, n_dropped: int) -> float:
        """Gradient rescale when dropping k of N DP shards."""
        return n_workers / max(n_workers - n_dropped, 1)
