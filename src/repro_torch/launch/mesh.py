"""Production and debug meshes, the PyTorch port of
:mod:`repro.launch.mesh`.

Both are functions (never module-level constants), so importing this
module touches no device. A mesh is a :class:`~repro_torch.dist.elastic.
Mesh` of devices over named axes; the port's mesh paths take a mesh that
lists one device once per position (``dist/sharding.py::use_mesh``), so
by default the production mesh lists the card 256 (or 512) times. Pass
``devices="cpu"`` (one device, listed once per position) or a list of
exactly as many devices as the mesh has positions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist.elastic import Mesh, _cuda_devices
from repro_torch.kernels.ops import resolve_device


def _layout(shape: tuple, axes: tuple, devices) -> Mesh:
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = [resolve_device(devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a {shape} mesh has {n} positions; "
                             f"{len(devs)} devices were given")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The deployment's mesh: ``("data", "model")`` of (16, 16), or
    ``("pod", "data", "model")`` of (2, 16, 16) with ``multi_pod``.
    ``devices``: ``None`` (the card, once per position; raises without
    one), one device, or one device per position."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _layout(shape, axes, devices)


def make_debug_mesh(data: int = 2, model: int = 2, devices=None) -> Mesh:
    """A small ``("data", "model")`` mesh over the devices there are
    (default: every visible card, raising without one), clamped as the
    reference clamps it to its local device count."""
    devs = _cuda_devices() if devices is None else list(devices)
    n = len(devs)
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _layout((data, model), ("data", "model"), devs[:data * model])
