"""Delta gradient compression with error feedback, the PyTorch port of
:mod:`repro.dist.grad_compress`.

The same thresholding law the DeltaGRU applies to activations (Eq. 2),
applied to the data-parallel gradient exchange: an element is sent only if
the accumulated update ``grad + residual`` moved by at least ``theta``;
unsent mass stays in a residual and telescopes into later steps, so no
gradient mass is ever lost (each step ``sent + new_residual == grads +
residual`` element for element, exactly).

``quantile`` mode picks the threshold per step from the global |grad|
distribution: a fixed wire budget instead of a fixed threshold, the
gradient-side analogue of the dynamic-Θ controller.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.sparsity import recip_mean
from repro_torch.train.optim import tree_leaves, tree_map


@dataclass(frozen=True)
class CompressionConfig:
    theta: float = 0.0
    quantile: float | None = None   # if set, overrides theta each step
    enabled: bool = True


def init_residual(grads):
    """Zero error-feedback residual, matching the grads tree (f32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _quantile(v: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(v, q)`` of a 1-D float32 tensor, its default linear
    interpolation in float32 between two order statistics of a sort (no
    size limit, unlike ``torch.quantile``)."""
    s = torch.sort(v).values
    n1 = torch.tensor(float(v.numel()), dtype=torch.float32,
                      device=v.device) - 1
    pos = torch.tensor(q, dtype=torch.float32, device=v.device) * n1
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    lo = torch.clamp(low, 0, n1).long()
    hi = torch.clamp(high, 0, n1).long()
    return s[lo] * low_weight + s[hi] * high_weight


def compress(grads, residual, cfg: CompressionConfig):
    """Threshold ``grads + residual``; returns (sent, new_residual, stats).

    Plain tensor ops, so it sits in a train step between the gradient and
    the optimizer update (the data-parallel hook position) without a host
    synchronisation.
    """
    if not cfg.enabled:
        dev = tree_leaves(grads)[0].device
        return grads, residual, {
            "fired_fraction": torch.tensor(1.0, device=dev),
            "threshold": torch.tensor(0.0, device=dev)}
    total = tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    abs_all = torch.cat([torch.abs(t).ravel() for t in tree_leaves(total)])
    if cfg.quantile is not None:
        theta = _quantile(abs_all, cfg.quantile)
    else:
        theta = torch.tensor(cfg.theta, dtype=torch.float32,
                             device=abs_all.device)
    sent = tree_map(lambda t: torch.where(torch.abs(t) >= theta, t, 0.0),
                    total)
    new_residual = tree_map(lambda t, s: t - s, total, sent)
    fired = recip_mean((abs_all >= theta).to(torch.float32))
    return sent, new_residual, {"fired_fraction": fired, "threshold": theta}
