"""Optimizers and LR schedules, the PyTorch port of :mod:`repro.train.optim`.

Adam/AdamW with global-norm clipping (the paper trains all networks with
Adam, Sec. IV-A) and SGD with momentum, as plain functions over a tree of
tensors (a dict, list, tuple or NamedTuple of them, such as a GRU model).
The state layout is the JAX package's, ``{"mu", "nu", "step"}`` with
``step`` an int32 0-d tensor on the parameters' device, and the arithmetic
follows its order, so a checkpoint of either package's optimizer state
restores into the other. Nothing here synchronises the host: the step
count, learning rate and clip scale stay tensors on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); containers are dicts, lists,
    tuples and NamedTuples, rebuilt as they were."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order (a
    dict's keys sorted), so sums over leaves add in the JAX order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _part(structure, out, i: int):
    """Element ``i`` of each tuple leaf of ``out``, a tree shaped like
    ``structure`` whose leaves are tuples."""
    return tree_map(lambda _, o: o[i], structure, out)


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


# ---------------------------------------------------------------------------
# Schedules (step -> lr, a float32 0-d tensor on the step's device)
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.full_like(_f32(step), lr)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, final_frac: float = 0.1) -> Callable:
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = (final_frac + (1 - final_frac) * 0.5
               * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamConfig:
    schedule: Callable = field(default_factory=lambda: constant_schedule(3e-4))
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0      # AdamW decoupled decay
    clip_norm: float | None = 1.0


def _zero_step(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def init_adam_state(params):
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": _zero_step(params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    # a true division: ``max_norm / tensor`` multiplies by a reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    # JAX promotes a bf16 gradient times the fp32 scale to fp32; PyTorch
    # would keep a 0-d operand from promoting and round the product to bf16
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads), norm


@torch.no_grad()
def adam_update(grads, state, params, cfg: AdamConfig):
    """Returns (new_params, new_state, metrics)."""
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    step = state["step"] + 1
    lr = cfg.schedule(step)
    metrics["lr"] = lr
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    corr1, corr2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(g, mu, nu, p):
        g = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        delta = (mu / corr1) / (torch.sqrt(nu / corr2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    out = tree_map(lambda p, g, mu, nu: upd(g, mu, nu, p), params, grads,
                   state["mu"], state["nu"])
    return (_part(params, out, 0),
            {"mu": _part(params, out, 1), "nu": _part(params, out, 2),
             "step": step}, metrics)


# ---------------------------------------------------------------------------
# SGD (baseline / ablations)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SgdConfig:
    schedule: Callable = field(default_factory=lambda: constant_schedule(1e-2))
    momentum: float = 0.9
    clip_norm: float | None = None


def init_sgd_state(params):
    return {"vel": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params),
            "step": _zero_step(params)}


@torch.no_grad()
def sgd_update(grads, state, params, cfg: SgdConfig):
    if cfg.clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = cfg.schedule(step)

    def upd(g, v, p):
        v = cfg.momentum * v + g.to(torch.float32)
        return (p.to(torch.float32) - lr * v).to(p.dtype), v

    out = tree_map(lambda p, g, v: upd(g, v, p), params, grads, state["vel"])
    return (_part(params, out, 0), {"vel": _part(params, out, 1),
                                    "step": step}, {})
