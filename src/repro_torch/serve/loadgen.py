"""Open-loop load generation for the distributed serving fabric, the
PyTorch port of :mod:`repro.serve.loadgen` (pure numpy, as there).

:func:`poisson_arrivals` draws a seeded open-loop Poisson arrival
schedule (exponential inter-arrival gaps, floored to router ticks) of
short-lived streams; :func:`run_fabric_load` replays it against a
:class:`~repro_torch.serve.router.StreamRouter` — arrivals land at their
scheduled tick regardless of system state (open loop: backpressure shows
up as rejections, not as a slowed generator), with an optional elastic
scale-down fired mid-load at a FIXED tick.

Everything the generator decides is tick-counted and seeded, so a run's
entire event history (placements, rejections, sheds, the rebalance, every
latency-in-ticks) reproduces exactly on any machine and in either package:
the draws come in the JAX package's order (gaps, then lengths, then one
``standard_normal`` block a stream), so a seed gives the same schedule, and
the arrival ticks and lengths are drawn before any frame, so the schedule's
timing does not depend on the frames' width. Wall-clock only ever appears
as a measurement (tick walls, throughput).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["poisson_arrivals", "run_fabric_load", "LoadRunSummary"]


def poisson_arrivals(n_streams: int, rate_per_tick: float, *,
                     min_len: int, max_len: int, input_size: int,
                     seed: int = 0) -> list[tuple[int, np.ndarray]]:
    """A seeded open-loop Poisson arrival schedule.

    Returns ``[(arrival_tick, frames [T, I]), ...]`` sorted by tick, with
    stream lengths uniform on ``[min_len, max_len]`` and standard-normal
    frames — short-lived streams, the serving fabric's target traffic.
    """
    if n_streams < 1 or rate_per_tick <= 0 or min_len < 1 \
            or max_len < min_len:
        raise ValueError(
            f"bad load shape: n_streams={n_streams}, "
            f"rate_per_tick={rate_per_tick}, len=[{min_len}, {max_len}]")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_tick, size=n_streams)
    ticks = np.floor(np.cumsum(gaps)).astype(int)
    lens = rng.integers(min_len, max_len + 1, size=n_streams)
    return [(int(t), rng.standard_normal((int(ln), input_size))
             .astype(np.float32))
            for t, ln in zip(ticks, lens)]


@dataclass
class LoadRunSummary:
    """What one load run produced (results keyed by arrival index)."""

    results: dict                 # arrival index -> RouterResult
    peak_concurrent: int          # max(in service + queued) over the run
    peak_concurrent_full: int     # same, while the FULL fleet was alive
    peak_active: int              # max slots simultaneously in service
    ticks: int
    scale_info: dict | None      # fleet.remove_shard info (if fired)


def run_fabric_load(router, arrivals, *, scale_down_at: int | None = None,
                    scale_down_shard: int = 0, ckpt_dir: str | None = None,
                    max_ticks: int = 100000, on_tick=None
                    ) -> LoadRunSummary:
    """Replay an arrival schedule through a router until drained.

    ``scale_down_at`` fires ``router.scale_down(scale_down_shard)`` at
    that exact tick (before that tick's arrivals) — the simulated device
    loss. ``on_tick(router, tick)`` is an observation hook.
    """
    results: dict[int, object] = {}
    uid2arr: dict[int, int] = {}
    scale_info = None
    peak = peak_full = peak_active = 0
    i = 0
    while True:
        tick = router.tick_no
        if scale_down_at is not None and tick == scale_down_at \
                and scale_info is None:
            scale_info = router.scale_down(scale_down_shard,
                                           ckpt_dir=ckpt_dir)
        while i < len(arrivals) and arrivals[i][0] <= tick:
            uid, admitted = router.submit(arrivals[i][1])
            uid2arr[uid] = i
            if not admitted:
                results[i] = router.results[-1]
            i += 1
        for res in router.tick():
            results[uid2arr[res.uid]] = res
        active = router.active_slots()
        concurrent = active + router.queue_depth()
        peak = max(peak, concurrent)
        peak_active = max(peak_active, active)
        if scale_info is None:
            peak_full = max(peak_full, concurrent)
        if on_tick is not None:
            on_tick(router, tick)
        if i >= len(arrivals) and router.idle():
            break
        if router.tick_no >= max_ticks:
            raise RuntimeError(
                f"load run exceeded max_ticks={max_ticks}: "
                f"{router.queue_depth()} queued + {router.in_flight()} "
                "in flight")
    assert len(results) == len(arrivals), \
        (len(results), len(arrivals))  # every arrival reached a terminal
    return LoadRunSummary(results=results, peak_concurrent=peak,
                          peak_concurrent_full=peak_full,
                          peak_active=peak_active, ticks=router.tick_no,
                          scale_info=scale_info)
