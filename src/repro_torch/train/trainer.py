"""The paper's train step and the training loop, the PyTorch port of the
GRU part of :mod:`repro.train.trainer`.

``make_gru_train_step`` builds the paper's CTC / regression step with QAT:
the forward of :func:`repro_torch.models.gru_rnn.gru_model_forward` on the
``dense`` backend, gradients by autograd's ``backward`` (the JAX package's
``jax.value_and_grad``), then :func:`repro_torch.train.optim.adam_update`.
The step runs eagerly, one PyTorch op at a time, on the device of the
parameters. The loop handles checkpoint cadence and metric logging.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.gru_rnn import GruTaskConfig, gru_model_forward
from repro_torch.quant.qat import FP32, QatPolicy
from repro_torch.train.losses import ctc_loss_mean, mse_loss
from repro_torch.train.optim import (AdamConfig, adam_update,
                                     init_adam_state, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: Any

    @property
    def step(self):
        return self.opt["step"]


def init_train_state(params, opt_cfg: AdamConfig | None = None) -> TrainState:
    return TrainState(params=params, opt=init_adam_state(params))


def make_gru_train_step(task: GruTaskConfig, opt_cfg: AdamConfig,
                        qat: QatPolicy = FP32, use_delta: bool = True):
    """Paper training step ``step(state, batch) -> (state, metrics)``.
    batch: ``{features [T,B,I], labels, in_lens, lab_lens}`` for CTC, or
    ``{features, targets [T,B,O]}`` for regression, on the parameters'
    device. Metrics are 0-d tensors on that device (``loss``, ``ctc`` or
    ``mse``/``rmse``, ``grad_norm`` with clipping, ``lr``)."""

    def loss_fn(params, batch):
        out, _ = gru_model_forward(params, task, batch["features"],
                                   use_delta=use_delta, qat=qat)
        if task.task == "ctc":
            loss, metrics = ctc_loss_mean(out, batch["labels"],
                                          batch["in_lens"], batch["lab_lens"])
        else:
            loss, metrics = mse_loss(out, batch["targets"])
        metrics["loss"] = loss
        return loss, metrics

    def step(state: TrainState, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        new_params, opt, opt_metrics = adam_update(grads, state.opt,
                                                   state.params, opt_cfg)
        metrics.update(opt_metrics)
        return TrainState(new_params, opt), metrics

    return step


@dataclass
class LoopHooks:
    on_step: Callable | None = None           # (step, metrics) -> None
    checkpoint_every: int = 0
    save_checkpoint: Callable | None = None   # (step, state) -> None


def train_loop(step_fn, state: TrainState, batches, num_steps: int,
               hooks: LoopHooks | None = None):
    """Run ``num_steps`` steps; returns (state, history). ``batches`` is an
    iterator/iterable of batch dicts. Each step's metrics are read to the
    host (``float``), which waits for the step."""
    hooks = hooks or LoopHooks()
    history = []
    it = iter(batches)
    for i in range(num_steps):
        batch = next(it)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - t0
        history.append(metrics)
        if hooks.on_step:
            hooks.on_step(i, metrics)
        if (hooks.checkpoint_every and hooks.save_checkpoint
                and (i + 1) % hooks.checkpoint_every == 0):
            hooks.save_checkpoint(i + 1, state)
    return state, history
