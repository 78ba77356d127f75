"""Delta-threshold policies, the PyTorch port of :mod:`repro.core.thresholds`.

* :class:`ThresholdPolicy` — static per-layer dual thresholds (Θ_x, Θ_h),
  in float or the paper's Q8.8 integer convention (Θ=64 == 0.25).
* :func:`dynamic_threshold` — the closed-loop controller that scales Θ by
  the ratio of measured to target firing rate.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

Q88_SCALE = 256.0  # paper quotes thresholds as Q8.8 integers: 64 -> 0.25


def q88(theta_int: float) -> float:
    """Convert a paper-style Q8.8 integer threshold to float."""
    return theta_int / Q88_SCALE


@dataclass(frozen=True)
class ThresholdPolicy:
    """Static dual-threshold policy, optionally per-layer.

    ``per_layer_x`` / ``per_layer_h`` override the global thresholds for
    the layers they cover; layers beyond them fall back to ``theta_x`` /
    ``theta_h``.
    """

    theta_x: float = 0.0
    theta_h: float = 0.0
    per_layer_x: tuple = field(default=())
    per_layer_h: tuple = field(default=())

    def layer(self, idx: int) -> tuple[float, float]:
        tx = self.per_layer_x[idx] if idx < len(self.per_layer_x) else self.theta_x
        th = self.per_layer_h[idx] if idx < len(self.per_layer_h) else self.theta_h
        return tx, th

    @property
    def has_per_layer(self) -> bool:
        return bool(self.per_layer_x) or bool(self.per_layer_h)

    def layer_thetas(self, num_layers: int) -> tuple[tuple, tuple]:
        """Per-layer ``(theta_x[...], theta_h[...])`` tuples."""
        pairs = [self.layer(l) for l in range(num_layers)]
        return (tuple(tx for tx, _ in pairs), tuple(th for _, th in pairs))

    @classmethod
    def global_q88(cls, theta_int: float) -> "ThresholdPolicy":
        t = q88(theta_int)
        return cls(theta_x=t, theta_h=t)

    @classmethod
    def dual_q88(cls, theta_x_int: float, theta_h_int: float) -> "ThresholdPolicy":
        return cls(theta_x=q88(theta_x_int), theta_h=q88(theta_h_int))


def dynamic_threshold(theta, fired_fraction, target_fired_fraction,
                      gain: float = 0.5, theta_min: float = 0.0,
                      theta_max: float = 1.0,
                      theta_floor: float = 1.0 / Q88_SCALE) -> torch.Tensor:
    """Closed-loop Θ controller: ``theta <- clip(theta * (fired/target)^gain)``.

    On overshoot (``fired > target``) Θ is first lifted to at least
    ``theta_floor`` (one Q8.8 LSB), so a stream opened at Θ = 0 can still
    be throttled; undershoot keeps the pure multiplicative decay. Tensor
    ops only, so it runs inside a step without a host sync.

    A Python-number ``fired_fraction`` (a host measurement, such as a
    queue depth) keeps the ratio and its power in Python floats, as the
    JAX package's weakly typed scalars do; only the product with Θ is
    float32.
    """
    dev = next((t.device for t in (theta, fired_fraction)
                if isinstance(t, torch.Tensor)), None)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    ratio = (fired_fraction + 1e-6) / (target_fired_fraction + 1e-6)
    if isinstance(ratio, torch.Tensor):
        theta = torch.where(ratio > 1.0,
                            torch.clamp(theta, min=theta_floor), theta)
    elif ratio > 1.0:
        theta = torch.clamp(theta, min=theta_floor)
    new_theta = theta * ratio ** gain
    return torch.clamp(new_theta, theta_min, theta_max)


def layer_theta(theta, idx: int):
    """Resolve a scalar-or-per-layer threshold for layer ``idx``."""
    if isinstance(theta, (tuple, list)):
        return theta[idx]
    return theta
