"""Train-step factories and the training loop, the PyTorch port of
:mod:`repro.train.trainer`.

``make_lm_train_step`` builds the step of any registry arch (cross-entropy
plus the MoE aux loss, AdamW with global-norm clipping, an optional
gradient transform for compression, microbatch accumulation);
``make_gru_train_step`` builds the paper's CTC / regression step with QAT.
Both are functional over the parameter trees: the forward (of
:func:`repro_torch.models.lm.lm_forward`, or of
:func:`repro_torch.models.gru_rnn.gru_model_forward` on the ``dense``
backend), gradients by autograd's ``backward`` (the JAX package's
``jax.value_and_grad``), then :func:`repro_torch.train.optim.adam_update`.
A step runs eagerly, one PyTorch op at a time, on the device of the
parameters. Under autograd the LM blocks run the plain scans
(:mod:`repro_torch.models.blocks`): the scan kernels have no backward. The
loop handles checkpoint cadence and metric logging.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (NamedSharding, current_mesh,
                                       infer_param_specs,
                                       with_sharding_constraint)
from repro_torch.models.gru_rnn import GruTaskConfig, gru_model_forward
from repro_torch.models.lm import lm_forward
from repro_torch.quant.qat import FP32, QatPolicy
from repro_torch.train.losses import ctc_loss_mean, lm_loss, mse_loss
from repro_torch.train.optim import (AdamConfig, adam_update,
                                     init_adam_state, tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: Any

    @property
    def step(self):
        return self.opt["step"]


def init_train_state(params, opt_cfg: AdamConfig | None = None) -> TrainState:
    return TrainState(params=params, opt=init_adam_state(params))


def _grads(live, what: str):
    """The gradients of ``live`` (leaves that required grad) after
    ``backward``. A leaf without one, cut off from the loss, raises: a
    zero in its place would hide the cut."""
    missing = sum(p.grad is None for p in tree_leaves(live))
    if missing:
        raise RuntimeError(f"{what}: {missing} parameter leaves got no "
                           "gradient (cut off from the loss)")
    return tree_map(lambda p: p.grad, live)


def make_lm_train_step_fn(cfg: ModelConfig, opt_cfg: AdamConfig,
                          aux_weight: float = 0.01,
                          grad_transform: Callable | None = None,
                          grad_accum: int = 1,
                          accum_rules=None):
    """``step(state, batch) -> (state, metrics)`` for any registry arch.

    ``batch``: dict with ``tokens [B, S]`` (+ ``image_embeds`` /
    ``audio_frames`` for the VLM / the encoder-decoder), on the
    parameters' device. The loss is ``lm_loss`` (next-token cross-entropy
    with a z-loss) plus ``aux_weight`` times the MoE aux loss. Metrics are
    0-d tensors on that device: ``loss``, ``ce``, ``accuracy``,
    ``tokens``, ``aux``, ``grad_norm`` (with clipping) and ``lr``.

    ``grad_accum > 1`` loops over that many microbatches (the batch dim
    must divide), accumulating the gradients in fp32, then divides by
    ``grad_accum`` and averages the metrics, as the reference's
    ``lax.scan`` does: the live activations scale with the microbatch.
    ``accum_rules`` (an ``AxisRules``) lays the fp32 accumulator out as
    the ZeRO-1 optimizer state under the active mesh
    (``infer_param_specs``, each spec checked as a sharding constraint);
    without a mesh, or with one microbatch, it is ignored, as in the
    reference.

    Every parameter leaf must get a gradient from autograd: a leaf that
    does not (``None``, cut off from the loss) raises (``jax.grad`` would
    give it zeros); no arch of the registry has one."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_fn(params, batch):
        logits, aux = lm_forward(
            params, cfg, batch["tokens"],
            image_embeds=batch.get("image_embeds"),
            audio_frames=batch.get("audio_frames"))
        loss, metrics = lm_loss(logits, batch["tokens"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        total = loss + aux_weight * aux
        metrics["aux"] = aux
        metrics["loss"] = total
        return total, metrics

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, metrics = loss_fn(live, batch)
        total.backward()
        return (_grads(live, cfg.name),
                {k: v.detach() for k, v in metrics.items()})

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(params, batch)
        b = batch["tokens"].shape[0]
        if b % grad_accum:
            raise ValueError(f"a batch of {b} does not split into "
                             f"{grad_accum} microbatches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        mesh = current_mesh()
        if accum_rules is not None and mesh is not None:
            # ZeRO-1: the fp32 accumulator sharded like the optimizer
            # state even when the params are data-replicated
            specs = infer_param_specs(acc, rules=accum_rules, mesh=mesh)
            acc = tree_map(lambda z, sp: with_sharding_constraint(
                z, NamedSharding(mesh, sp)), acc, specs)
        per_mb = []
        for m in range(grad_accum):
            micro = {k: v.reshape(grad_accum, b // grad_accum,
                                  *v.shape[1:])[m] for k, v in batch.items()}
            grads, metrics = value_and_grad(params, micro)
            tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc, grads)
            per_mb.append(metrics)
            del grads
        grads = tree_map(lambda a: a / grad_accum, acc)
        metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                   for k in per_mb[0]}
        return grads, metrics

    def step(state: TrainState, batch):
        grads, metrics = compute_grads(state.params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt, opt_metrics = adam_update(grads, state.opt,
                                               state.params, opt_cfg)
        metrics.update(opt_metrics)
        return TrainState(params, opt), metrics

    return step


def make_lm_train_step(cfg: ModelConfig, opt_cfg: AdamConfig,
                       aux_weight: float = 0.01,
                       grad_transform: Callable | None = None,
                       donate: bool = True):
    """:func:`make_lm_train_step_fn` with one microbatch, the reference's
    jitted convenience wrapper. ``donate`` is the reference's donation of
    the old state to the step: the caller hands the state over and must
    not read it after the call. The eager step writes a new state and
    reuses no tensor of the old one, so the flag changes no computation;
    the old state's memory goes when the caller drops it (as the launcher
    does, rebinding ``state``)."""
    del donate
    return make_lm_train_step_fn(cfg, opt_cfg, aux_weight, grad_transform)


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
        grads = _grads(params, "the GRU step")
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
