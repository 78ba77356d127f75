"""Ranks: the port's mesh over distinct devices, one process a device.

The reference runs a mesh over several devices as one program that GSPMD
partitions. The port runs one process a device instead
(``torch.distributed``): each rank holds its block of a sharded layout, and
the collectives that GSPMD would insert are written out where the mesh paths
need them: the train step's all-reduce of the gradients, the expert-parallel
MoE's all-to-all, the pipeline's send / recv. The backend follows the
device, NCCL on a card and gloo on the CPU, and nothing else chooses it.

* :func:`init_ranks` joins this process to the group (torchrun's ``RANK``,
  ``WORLD_SIZE`` and ``LOCAL_RANK`` where the caller gives none) and
  returns its device;
* :func:`spawn_ranks` runs a function on ``world_size`` new processes over
  a ``file://`` store, with a deadline, and returns each rank's result;
* :func:`axis_group` is the group of the ranks that differ from this one
  only along some mesh axes (``repro_torch.dist.elastic.best_mesh`` builds
  a mesh over the ranks once the group is up);
* the differentiable collectives (:func:`all_gather`, :func:`all_to_all`,
  :func:`psum`, :func:`psum_disjoint`, :func:`psum_grads`) are what the
  mesh paths call.

Two conventions hold for gradients. Over the ``batch`` axes each rank holds
its own rows and the train step averages the ranks' gradients. Over the
other axes the ranks hold the same rows and compute one loss between them,
each rank a copy of it: there a gradient that a rank computes only a part
of is summed (:func:`psum_grads`), and an output that every rank holds in
full needs no reduction backward (:func:`psum_disjoint`).

``COLLECTIVES`` counts the collectives issued from the host by kind; a
captured step issues its collectives once, at the capture.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import resolve_device

__all__ = ["DEFAULT_TIMEOUT_S", "COLLECTIVES", "init_ranks", "destroy_ranks",
           "ranks_ready", "rank_device", "rank_devices", "spawn_ranks",
           "axis_group", "all_gather", "all_to_all", "psum", "psum_disjoint",
           "psum_grads",
           "all_reduce_", "send_recv", "broadcast_"]

# a collective that waits longer than this fails (the process group's
# timeout), so that a lost rank ends the run rather than hanging it
DEFAULT_TIMEOUT_S = 300.0

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0,
               "send_recv": 0, "broadcast": 0}

_RANKS: dict = {}       # "device": this rank's, "devices": every rank's
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _env_int(name: str):
    value = os.environ.get(name)
    return None if value is None else int(value)


def init_ranks(device=None, *, rank: int | None = None,
               world_size: int | None = None, init_method: str | None = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the group of ranks and return its device.

    ``rank`` / ``world_size`` default to torchrun's ``RANK`` /
    ``WORLD_SIZE``, ``init_method`` to ``"env://"`` (torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``). ``device``: ``"cuda"`` (the
    default) is ``cuda:<LOCAL_RANK>`` (the rank's index without
    ``LOCAL_RANK``), ``"cpu"`` the CPU. The backend follows the device,
    NCCL for a card and gloo for the CPU (``BACKENDS``), and nothing else
    chooses it. A collective that waits ``timeout`` seconds fails."""
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("init_ranks: no rank or world size given and no "
                         "torchrun environment (RANK, WORLD_SIZE)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} of a world of {world_size}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = _env_int("LOCAL_RANK")
        dev = torch.device("cuda", rank if local is None else local)
    want = BACKENDS.get(dev.type)
    if want is None:
        raise ValueError(f"init_ranks: no backend for a {dev.type} device")
    if dist.is_initialized():
        raise RuntimeError("init_ranks: this process already joined a group")
    if dev.type == "cuda":
        resolve_device(dev)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        want, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout),
        device_id=dev if dev.type == "cuda" else None)
    devices = [None] * world_size
    dist.all_gather_object(devices, str(dev))
    _RANKS.update(device=dev, devices=[torch.device(d) for d in devices])
    return dev


def ranks_ready() -> bool:
    """True once :func:`init_ranks` has joined this process to a group."""
    return bool(_RANKS) and dist.is_initialized()


def _need_ranks():
    if not ranks_ready():
        raise RuntimeError("no process group: call init_ranks first")


def rank_device() -> torch.device:
    """This rank's device."""
    _need_ranks()
    return _RANKS["device"]


def rank_devices() -> list:
    """Every rank's device, in rank order."""
    _need_ranks()
    return list(_RANKS["devices"])


def destroy_ranks() -> None:
    """Leave the group (every rank calls it) and forget its devices."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANKS.clear()


# -- processes ---------------------------------------------------------------

def _child(fn, rank, world_size, device, workdir, timeout, args):
    torch.set_num_threads(1)
    out = os.path.join(workdir, f"rank{rank}")
    try:
        init_ranks(device, rank=rank, world_size=world_size,
                   init_method=f"file://{os.path.join(workdir, 'store')}",
                   timeout=timeout)
        result = fn(rank, *args)
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".result")
    except BaseException:
        with open(out + ".tmp", "w") as f:
            f.write(traceback.format_exc())
        os.replace(out + ".tmp", out + ".error")
        raise SystemExit(1)
    finally:
        destroy_ranks()


def _raise_first_error(root: str, world_size: int) -> None:
    """Raise the traceback of the first rank to fail, if one has: the
    others fail after it, as their collectives lose it."""
    errors = sorted((os.stat(os.path.join(root, f)).st_mtime_ns, f)
                    for f in os.listdir(root) if f.endswith(".error"))
    if errors:
        first = errors[0][1]
        with open(os.path.join(root, first)) as f:
            raise RuntimeError(f"{first[:-6]} of {world_size} failed:\n"
                               f"{f.read()}")


def spawn_ranks(fn, world_size: int, device, workdir=None,
                timeout: float = 120.0, args: tuple = ()) -> list:
    """``fn(rank, *args)`` on ``world_size`` new processes, one a rank, and
    their results in rank order (pickled through files).

    Each child sets one CPU thread and joins the group over a ``file://``
    store in a new directory under ``workdir`` (no port, so runs in
    parallel do not meet); its device is ``device``, which the caller
    names: ``"cuda"`` (``cuda:<rank>``, NCCL) or ``"cpu"`` (gloo). ``fn`` must be importable by name from a
    module the child can import. The parent waits ``timeout`` seconds in
    all; at a child's failure or at the deadline it kills every child and
    raises, with the failed child's traceback."""
    root = tempfile.mkdtemp(prefix="ranks-", dir=workdir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world_size, device, root,
                                              timeout, args), daemon=True)
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            _raise_first_error(root, world_size)
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: {world_size} ranks did not "
                                   f"finish in {timeout} s")
            time.sleep(0.02)
        _raise_first_error(root, world_size)
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"rank{r}.result")
            if p.exitcode != 0 or not os.path.exists(path):
                raise RuntimeError(f"rank{r} of {world_size} exited with "
                                   f"{p.exitcode} and no result")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5)
        shutil.rmtree(root, ignore_errors=True)


# -- groups ------------------------------------------------------------------

def axis_group(mesh, names) -> dist.ProcessGroup:
    """The group of the ranks of ``mesh`` (a mesh over the ranks) that share
    this rank's coordinate on every axis but ``names``, in mesh order.
    Every rank builds every such group at once (a collective), at the
    first call for these axes; later calls return it from the mesh."""
    names = (names,) if isinstance(names, str) else tuple(names)
    key = tuple(n for n in mesh.axis_names if n in names)
    if key not in mesh.groups:
        keep = [i for i, n in enumerate(mesh.axis_names) if n not in key]
        over = [i for i, n in enumerate(mesh.axis_names) if n in key]
        ranks = mesh.ranks.transpose(keep + over).reshape(
            -1, math.prod(mesh.ranks.shape[i] for i in over))
        mine, _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in row] for row in ranks])
        mesh.groups[key] = mine
    return mesh.groups[key]


# -- collectives -------------------------------------------------------------

def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns ``x``."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` of global rank ``src``, in place on every rank of ``group``."""
    COLLECTIVES["broadcast"] += 1
    dist.broadcast(x, src, group=group)
    return x


def send_recv(send: torch.Tensor | None, to: int | None,
              recv: torch.Tensor | None, frm: int | None) -> None:
    """One hop: ``send`` to global rank ``to`` and ``recv`` from ``frm``
    (either may be None), posted together and waited for."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send, to))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm))
    if ops:
        COLLECTIVES["send_recv"] += 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    out = torch.empty_like(x)
    COLLECTIVES["all_to_all"] += 1
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x: [n, ...]`` (``n`` the group's size): row ``j`` goes to the
    group's rank ``j``, and row ``j`` of the result came from its rank
    ``j``. Differentiable: the backward is the same exchange of the
    gradients."""
    return _AllToAll.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grads_summed):
        ctx.group, ctx.grads_summed = group, grads_summed
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grads_summed:
            g = all_reduce_(g.clone(), ctx.group)
        return g, None, None


class _PsumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.at = dist.get_group_rank(group, dist.get_rank())
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        COLLECTIVES["all_gather"] += 1
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.chunk(dist.get_world_size(ctx.group))[ctx.at], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in the group's order, on
    every rank. Each rank's loss reads all of it, so the backward sums the
    gradients over the group and hands each rank its own rows."""
    return _AllGather.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank; the backward sums the
    gradients over the group too (each rank's part of a sum that every
    rank's loss reads, as the router statistics of the ``batch`` axes)."""
    return _Psum.apply(x, group, True)


def psum_disjoint(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank, for parts that the
    ranks hold of one output of the group's one loss: the backward hands
    each rank its loss copy's gradient unchanged."""
    return _Psum.apply(x, group, False)


def psum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, held alike by the ranks of ``group``, each of which
    computes the gradient of only its part of the use: the backward sums
    the gradients over the group."""
    return _PsumGrads.apply(x, group)
