"""Optimizers and LR schedules, the PyTorch port of :mod:`repro.train.optim`.

Adam/AdamW with global-norm clipping (the paper trains all networks with
Adam, Sec. IV-A) and SGD with momentum, as plain functions over a tree of
tensors (a dict, list, tuple or NamedTuple of them, such as a GRU model).
The state layout is the JAX package's, ``{"mu", "nu", "step"}`` with
``step`` an int32 0-d tensor on the parameters' device, and the arithmetic
follows its order, so a checkpoint of either package's optimizer state
restores into the other. Nothing here synchronises the host: the step
count, learning rate and clip scale stay tensors on the device.

``adam_update`` computes the global norm through
:func:`repro_torch.kernels.ops.global_norm` (one launch of the hand-written
kernel on a CUDA device, ``global_norm_ref``'s ops on the CPU), the clip
scale, the learning rate and the bias corrections in plain ops, then
updates every leaf through :func:`repro_torch.kernels.ops.fused_adam`: one
launch of the hand-written kernel a parameter dtype on a CUDA device, the
same per-leaf ops as before the kernel (``fused_adam_ref``) on the CPU.
Over a state sharded over ranks the leaves are each rank's blocks: the
norm adds the ranks' sums of squares before the root
(:func:`global_norm`'s ``over``), and the update runs on the blocks.
Within :func:`updates_in_place`
it writes the new parameters and moments into the tensors it was given (a
compiled step's state buffers) instead of new ones.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.dist.ranks import all_reduce_
from repro_torch.kernels import ops


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


def global_norm(tree, over=None) -> torch.Tensor:
    """``sqrt`` of the sum of the squares of every leaf, in fp32: one launch
    of the hand-written kernel on a CUDA device, the JAX package's ops on
    the CPU (:func:`repro_torch.kernels.ops.global_norm`).

    ``over``: ``(mine, group)`` where ``tree`` holds this rank's blocks of
    a tree sharded over the ranks of ``group``; ``mine``, a tree of bools
    shaped like it, marks the leaves this rank adds (each block of a
    sharded leaf on one rank of the group, a replicated leaf on one rank).
    The rank's sum of squares over them (one launch, the kernel's fp32
    total before its root) is summed over the group, then the root is
    taken."""
    if over is None:
        return ops.global_norm(tree_leaves(tree))
    mine, group = over
    leaves = tree_leaves(tree)
    picked = [x for x, m in zip(leaves, tree_leaves(mine)) if m]
    # a rank that adds no leaf sums an empty one: its launch writes 0
    squares = ops.global_norm(picked or [leaves[0].new_zeros(0)],
                              squares=True)
    return torch.sqrt(all_reduce_(squares.clone(), group))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-9))``, a 0-d tensor beside ``norm``."""
    # a true division: ``max_norm / tensor`` multiplies by a reciprocal
    return torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                       max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    # JAX promotes a bf16 gradient times the fp32 scale to fp32; PyTorch
    # would keep a 0-d operand from promoting and round the product to bf16
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype))
                    * scale, grads), norm


_IN_PLACE = [False]


@contextmanager
def updates_in_place():
    """Within this, :func:`adam_update` writes the new parameters, moments
    and step count into the leaves of the ``params`` and ``state`` it is
    given and returns those same tensors: what a compiled step does to its
    state buffers. The caller must hold no other use for the old values."""
    _IN_PLACE.append(True)
    try:
        yield
    finally:
        _IN_PLACE.pop()


def in_place() -> bool:
    """Whether the caller is within :func:`updates_in_place`."""
    return _IN_PLACE[-1]


@torch.no_grad()
def adam_update(grads, state, params, cfg: AdamConfig, norm_over=None):
    """Returns (new_params, new_state, metrics). ``norm_over``: the clip
    norm's ``over`` where the leaves are blocks of a sharded tree
    (:func:`global_norm`)."""
    metrics = {}
    scale = None
    if cfg.clip_norm is not None:
        gnorm = global_norm(grads, norm_over)
        scale = clip_scale(gnorm, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    in_place = _IN_PLACE[-1]
    step = state["step"].add_(1) if in_place else state["step"] + 1
    lr = cfg.schedule(step)
    metrics["lr"] = lr
    t = step.to(torch.float32)
    corr1, corr2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t

    flat = []         # (p, g, mu, nu) in tree_map's order
    tree_map(lambda *leaves: flat.append(leaves), params, grads, state["mu"],
             state["nu"])
    p, g, mu, nu = (list(col) for col in zip(*flat)) if flat else ([],) * 4
    out = (p, mu, nu) if in_place else None
    new = ops.fused_adam(p, g, mu, nu, scale=scale, lr=lr, corr1=corr1,
                         corr2=corr2, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                         weight_decay=cfg.weight_decay, out=out)

    def rebuild(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), params)
    return (rebuild(new[0]),
            {"mu": rebuild(new[1]), "nu": rebuild(new[2]), "step": step},
            metrics)


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
    in_place = _IN_PLACE[-1]
    step = state["step"].add_(1) if in_place else state["step"] + 1
    lr = cfg.schedule(step)

    def upd(g, v, p):
        v = cfg.momentum * v + g.to(torch.float32)
        return (p.to(torch.float32) - lr * v).to(p.dtype), v

    out = tree_map(lambda p, g, v: upd(g, v, p), params, grads, state["vel"])
    return (_part(params, out, 0), {"vel": _part(params, out, 1),
                                    "step": step}, {})
