"""Crash-consistent restart orchestration, the PyTorch port of
:mod:`repro.ft.restart`.

Two layers:

* :func:`with_restarts` — the generic driver: run a resumable body to
  completion, retrying on failure up to a restart budget. The body must be
  resumable by construction (consult the published checkpoint on entry);
  the driver only supplies the retry loop, so the same machinery serves
  :func:`run_resumable` and the resilient serving tier
  (:func:`repro_torch.serve.resilience.serve_resumable`).
* :func:`run_resumable` — wraps a loop of steps over a state of tensors so
  that any crash resumes from the last published checkpoint with
  bit-identical state.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

from repro_torch.ft import checkpoint as ckpt


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    save_every: int = 10


def with_restarts(body: Callable, max_restarts: int = 3, *,
                  on_restart: Callable | None = None,
                  retryable: tuple = (Exception,)):
    """Run ``body()`` to completion, retrying on failure.

    ``body`` must make itself resumable (e.g. restore from the latest
    published checkpoint when one exists): this driver re-enters it from
    the top after every failure. Exceptions outside ``retryable`` (and any
    failure past ``max_restarts``) propagate. ``on_restart(restart_no)``
    runs before each re-entry. Returns ``(result, restarts)``.
    """
    restarts = 0
    while True:
        try:
            return body(), restarts
        except retryable:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts)


def run_resumable(make_state: Callable, step_fn: Callable,
                  batch_iter_fn: Callable, num_steps: int,
                  policy: RestartPolicy, device=None) -> tuple:
    """Run ``num_steps`` of ``state, metrics = step_fn(state, batch)``; on
    any exception, restore the last checkpoint onto ``device`` (default
    ``"cuda"``) and continue.

    ``make_state()`` builds the step-0 state (a tree of tensors);
    ``batch_iter_fn(start_step)`` must be deterministic in the step index
    so the resumed data stream matches.

    Returns (state, history, restarts).
    """
    mgr = ckpt.CheckpointManager(policy.ckpt_dir, every=policy.save_every,
                                 keep=3, async_write=False)
    history: list = []
    template = make_state()

    def body():
        nonlocal history
        start = ckpt.latest_step(policy.ckpt_dir) or 0
        state = (ckpt.restore(policy.ckpt_dir, template, device=device)
                 if start else template)
        history = history[:start]
        step = start
        batches = batch_iter_fn(step)
        while step < num_steps:
            batch = next(batches)
            state, metrics = step_fn(state, batch)
            step += 1
            history.append({k: float(v) for k, v in metrics.items()})
            mgr.maybe_save(step, state)
        return state

    state, restarts = with_restarts(body, policy.max_restarts)
    return state, history, restarts
