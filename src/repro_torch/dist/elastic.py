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
for the JAX package). Once this process has joined a group of ranks
(:func:`repro_torch.dist.ranks.init_ranks`), ``best_mesh()`` without
devices lays the mesh over the ranks instead, one process a device: each
position is a rank, and its device that rank's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.dist.ranks import rank_devices, ranks_ready
from repro_torch.kernels.ops import resolve_device

__all__ = ["Mesh", "best_mesh", "scale_event"]


@dataclass
class Mesh:
    """Devices laid out over named axes (``jax.sharding.Mesh``'s role).

    ``devices`` is a numpy object array of ``torch.device``\\ s with one
    dimension per name in ``axis_names``; ``shape`` maps each axis name to
    its size, as JAX's ``dict(mesh.shape)`` does.

    A mesh over ranks also has ``ranks``, an int array of the same shape:
    the global rank of the process at each position, whose device is the
    position's. ``groups`` caches its process groups
    (:func:`repro_torch.dist.ranks.axis_group`)."""

    devices: np.ndarray
    axis_names: tuple = ("data", "model")
    ranks: np.ndarray | None = None
    groups: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.devices = np.asarray(self.devices, dtype=object)
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh devices of shape {self.devices.shape} do not match "
                f"the axis names {self.axis_names}")
        if self.ranks is not None:
            self.ranks = np.asarray(self.ranks, dtype=np.int64)
            if self.ranks.shape != self.devices.shape:
                raise ValueError(f"ranks of shape {self.ranks.shape} for "
                                 f"devices of shape {self.devices.shape}")

    @property
    def on_ranks(self) -> bool:
        """True for a mesh over ranks, one process a position."""
        return self.ranks is not None

    def coords(self, rank: int | None = None) -> dict:
        """The position of global ``rank`` (this process's by default) on a
        mesh over ranks: ``{axis name: coordinate}``."""
        if rank is None:
            rank = torch.distributed.get_rank()
        at = np.argwhere(self.ranks == rank)
        if len(at) != 1:
            raise ValueError(f"rank {rank} holds {len(at)} positions of the "
                             f"mesh over ranks {self.ranks.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in at[0])))

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
    shards). ``n_devices=None`` takes the whole list. Without ``devices``
    in a process that has joined a group of ranks, the mesh is over the
    ranks, ``(world // mp, mp)`` in rank order, and ``n_devices`` may only
    be the world's size.

    The requested model-parallel degree is clamped to a divisor of the
    device count, so an elastic scale-down never produces a ragged mesh.
    Scaling to zero devices is a fleet death, not a mesh: ``ValueError``.
    """
    if devices is None and ranks_ready():
        devs = rank_devices()
        if n_devices not in (None, len(devs)):
            raise ValueError(f"a mesh over {n_devices} of {len(devs)} ranks: "
                             "a mesh over ranks holds every rank")
        data, mp = _factorize(len(devs), model_parallel)
        return Mesh(np.array(devs, dtype=object).reshape(data, mp),
                    ("data", "model"),
                    ranks=np.arange(len(devs)).reshape(data, mp))
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
