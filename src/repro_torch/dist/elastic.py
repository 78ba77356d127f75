"""Elastic mesh construction, the PyTorch port of :mod:`repro.dist.elastic`:
pick the best (data, model) factorization for however many devices are
currently healthy, and plan remesh events when the fleet grows or shrinks
mid-run.

The port's mesh is a small :class:`Mesh`: a numpy object array of
``torch.device``\\ s shaped ``(data, model)``. :func:`best_mesh` takes its
devices from a list, by default every visible CUDA device; a device that
appears in the list more than once hosts that many shards
(``devices=[torch.device("cuda:0")] * 8`` puts 8 shards on one card, as
``--xla_force_host_platform_device_count=8`` puts 8 "devices" on one CPU
for the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

__all__ = ["Mesh", "best_mesh", "scale_event"]


@dataclass
class Mesh:
    """Devices laid out over named axes (``jax.sharding.Mesh``'s role).

    ``devices`` is a numpy object array of ``torch.device``\\ s with one
    dimension per name in ``axis_names``; ``shape`` maps each axis name to
    its size, as JAX's ``dict(mesh.shape)`` does."""

    devices: np.ndarray
    axis_names: tuple = ("data", "model")

    def __post_init__(self):
        self.devices = np.asarray(self.devices, dtype=object)
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh devices of shape {self.devices.shape} do not match "
                f"the axis names {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """The number of mesh positions (a device listed k times counts
        k times), as ``jax.sharding.Mesh.size``."""
        return int(self.devices.size)


def _cuda_devices() -> list:
    """Every visible CUDA device; raises without a card (no CPU fallback)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _factorize(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest model-parallel degree <= requested that divides the fleet.

    Callers must validate ``n_devices >= 1`` first: a zero/negative count
    would "factorize" into a degenerate ``(n, 1)`` mesh shape here.
    """
    mp = max(1, min(model_parallel, n_devices))
    while n_devices % mp:
        mp -= 1
    return n_devices // mp, mp


def best_mesh(n_devices: int | None = None, model_parallel: int = 1, *,
              devices=None) -> Mesh:
    """A ``("data", "model")`` mesh over ``n_devices`` of ``devices``
    (default: every visible CUDA device; a device listed k times hosts k
    shards). ``n_devices=None`` takes the whole list.

    The requested model-parallel degree is clamped to a divisor of the
    device count, so an elastic scale-down never produces a ragged mesh.
    Scaling to zero devices is a fleet death, not a mesh: ``ValueError``.
    """
    devs = _cuda_devices() if devices is None else list(devices)
    avail = len(devs)
    n = avail if n_devices is None else min(n_devices, avail)
    if n < 1:
        raise ValueError(
            f"best_mesh needs at least one device, got n_devices={n_devices} "
            f"({avail} available); a zero-device mesh is a fleet death, not "
            f"a resize")
    data, mp = _factorize(n, model_parallel)
    return Mesh(np.array([torch.device(d) for d in devs[:n]],
                         dtype=object).reshape(data, mp), ("data", "model"))


def scale_event(old_mesh: Mesh, new_n_devices: int,
                model_parallel: int = 1) -> dict:
    """Plan a remesh after an elastic resize; consumed by the restart policy
    (checkpoint -> rebuild mesh -> reshard-restore).

    Raises ``ValueError`` when asked to scale to fewer than one device —
    there is no ``(0, mp)`` mesh to reshard onto; that case must be handled
    as a full-fleet failure (checkpoint + halt), not a resize.
    """
    if new_n_devices < 1:
        raise ValueError(
            f"scale_event needs at least one surviving device, got "
            f"new_n_devices={new_n_devices}; scaling to zero is a full-fleet "
            f"failure (checkpoint + halt), not a resize")
    data, mp = _factorize(new_n_devices, model_parallel)
    old_shape = dict(old_mesh.shape)
    new_shape = {"data": data, "model": mp}
    return {
        "old_shape": old_shape,
        "new_shape": new_shape,
        "requires_resharding": old_shape != new_shape,
    }
