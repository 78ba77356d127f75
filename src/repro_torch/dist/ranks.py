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
  mesh paths call, and :func:`pmax` (no gradient) the split loss;
* :func:`gather_block` turns a rank's block of a sharded parameter into the
  global tensor (``all_gather_into_tensor`` along each sharded dim), and
  its backward hands the block of the reduced gradient back
  (``reduce_scatter_tensor``), as :class:`BlockPlan` says; where the rank
  computes only its slice of the tensor it takes that slice instead, by a
  cut or by :func:`swap_dims` (one all-to-all);
  :func:`reduce_scatter_bucket` and :func:`all_gather_bucket` do the same
  for many tensors in one collective a dtype.

Two conventions hold for gradients. Over the ``batch`` axes each rank holds
its own rows and the train step averages the ranks' gradients. Over the
other axes the ranks hold the same rows and compute one loss between them,
each rank a copy of it: there a gradient that a rank computes only a part
of is summed (:func:`psum_grads`), and an output that every rank holds in
full needs no reduction backward (:func:`psum_disjoint`). The tensor
parallelism of the ``model`` axis is these two operators around the work
a rank splits: Megatron's "f" (:func:`psum_grads`) on the way in, its "g"
(:func:`psum_disjoint`) on the way out.

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
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import resolve_device

__all__ = ["DEFAULT_TIMEOUT_S", "COLLECTIVES", "init_ranks", "destroy_ranks",
           "ranks_ready", "rank_device", "rank_devices", "spawn_ranks",
           "axis_group", "all_gather", "all_to_all", "psum", "psum_disjoint",
           "psum_grads", "pmax", "swap_dims", "BlockPlan", "cut",
           "gather_block", "gather_dim",
           "reduce_scatter_dim", "reduce_scatter_bucket", "all_gather_bucket",
           "all_reduce_", "send_recv", "broadcast_"]

# a collective that waits longer than this fails (the process group's
# timeout), so that a lost rank ends the run rather than hanging it
DEFAULT_TIMEOUT_S = 300.0

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0,
               "reduce_scatter": 0, "send_recv": 0, "broadcast": 0}

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
    code = 0
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
        code = 1
    finally:
        destroy_ranks()
    # The outcome is on disk: leave without the interpreter's teardown. A
    # rank's process was seen to abort there ("terminate called without an
    # active exception", no Python frame left) after its result was
    # written, under load, as objects of the process group's backend were
    # torn down.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


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


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group`` on every rank, with
    no gradient (a new tensor; an all-reduce, counted as one)."""
    out = x.detach().clone()
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def swap_dims(x: torch.Tensor, split: int, cat: int, group) -> torch.Tensor:
    """A tensor the group's ranks hold in blocks along ``cat`` turned into
    blocks along ``split``: ``x`` cut into the group's size of slices along
    ``split``, slice ``j`` sent to the group's rank ``j``, and the slices
    received concatenated along ``cat`` in the group's order (one
    ``all_to_all_single``). Rank ``j`` then holds the ``j``-th slice of
    ``split`` of the whole tensor, whole along ``cat``; the same call with
    ``split`` and ``cat`` exchanged undoes it (:func:`gather_block`'s
    backward)."""
    n = dist.get_world_size(group)
    src = torch.stack(x.chunk(n, dim=split)).contiguous()
    out = torch.empty_like(src)
    COLLECTIVES["all_to_all"] += 1
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.unbind(0), dim=cat)


# -- blocks of sharded tensors -----------------------------------------------

def _gather_into(out, x, group) -> None:
    COLLECTIVES["all_gather"] += 1
    dist.all_gather_into_tensor(out, x, group=group)


def _scatter_into(out, x, group) -> None:
    COLLECTIVES["reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, x, group=group)


def cut(x: torch.Tensor, cuts) -> torch.Tensor:
    """A view of ``x`` with each ``(dim, index, parts)`` of ``cuts`` cut to
    its ``index``-th of ``parts`` equal slices: a rank's block of a global
    tensor (``sharding.shard_cuts`` builds the triples)."""
    for dim, index, parts in cuts:
        step = x.shape[dim] // parts
        x = x.narrow(dim, index * step, step)
    return x


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in the group's
    order, on every rank of ``group``: one ``all_gather_into_tensor``. The
    result is contiguous (a gather along a later dim is copied into
    place), so an op reading it sees the layout of the global tensor."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather_into(out, src, group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group`` (in its dtype), and of the sum this rank's
    block along ``dim`` (the group's order): one ``reduce_scatter_tensor``."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _scatter_into(out, src, group)
    return out.movedim(0, dim)


def _by_dtype(tensors) -> dict:
    at: dict = {}
    for i, t in enumerate(tensors):
        at.setdefault(t.dtype, []).append(i)
    return at


def reduce_scatter_bucket(tensors: list, dims: list, group) -> list:
    """:func:`reduce_scatter_dim` of each ``tensors[i]`` along ``dims[i]``,
    in one ``reduce_scatter_tensor`` of a flat bucket a dtype (in the order
    the dtypes first appear, the same on every rank). Each result is a view
    of its bucket."""
    n = dist.get_world_size(group)
    out = [None] * len(tensors)
    for dtype, idx in _by_dtype(tensors).items():
        moved = [tensors[i].movedim(dims[i], 0) for i in idx]
        # row j of the bucket holds every tensor's block j
        flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
        mine = torch.empty(flat.shape[1], dtype=dtype, device=flat.device)
        _scatter_into(mine, flat.reshape(-1), group)
        sizes = [m.numel() // n for m in moved]
        for i, m, v in zip(idx, moved, mine.split(sizes)):
            v = v.view((m.shape[0] // n,) + tuple(m.shape[1:]))
            out[i] = v.movedim(0, dims[i])
    return out


def all_gather_bucket(blocks: list, dims: list, group) -> list:
    """The group's ``blocks[i]`` concatenated along ``dims[i]`` in the
    group's order, in one ``all_gather_into_tensor`` of a flat bucket a
    dtype. Each result is a view of its bucket."""
    n = dist.get_world_size(group)
    out = [None] * len(blocks)
    for dtype, idx in _by_dtype(blocks).items():
        moved = [blocks[i].movedim(dims[i], 0) for i in idx]
        flat = torch.cat([m.reshape(-1) for m in moved])
        got = torch.empty(n * flat.numel(), dtype=dtype, device=flat.device)
        _gather_into(got, flat, group)
        got = got.view(n, -1)
        at = 0
        for i, m in zip(idx, moved):
            piece = got[:, at:at + m.numel()].reshape(n, *m.shape)
            at += m.numel()
            out[i] = piece.reshape(n * m.shape[0], *m.shape[1:]).movedim(
                0, dims[i])
    return out


class BlockPlan(NamedTuple):
    """How :func:`gather_block` turns a rank's block into the tensor the
    rank computes with, and that tensor's gradient into the block's.

    ``gathers``: ``(dim, group)`` a sharded dim, gathered in turn.
    ``swap``: ``(split, cat, group)`` of a :func:`swap_dims` after them,
    or None: the rank takes its slice of ``split`` and the whole of
    ``cat``, which the group shards. ``take``: the :func:`cut` of a dim to
    the rank's slice after them, or ``()``; its backward pads the
    gradient with zeros. ``scatters``: ``(dim, group)`` a reduction of the
    gradient over a group whose ranks shard ``dim``, reduce-scattered in
    turn. ``divide``: the sum is then divided by it (the data extent,
    where the data group's reduction is among the scatters; 1 otherwise).
    ``slices``: the :func:`cut` of each sharded dim whose group no
    reduction covers, to the rank's slice."""

    gathers: tuple
    scatters: tuple
    divide: int
    slices: tuple
    swap: tuple | None = None
    take: tuple = ()


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        for dim, group in plan.gathers:
            x = gather_dim(x, dim, group)
        if plan.swap is not None:
            x = swap_dims(x, *plan.swap)
        ctx.shape = x.shape
        if plan.take:
            # a copy: the slice in storage of its own
            x = cut(x, plan.take).clone(memory_format=torch.contiguous_format)
        return x

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        if plan.take:
            whole = g.new_zeros(ctx.shape)
            cut(whole, plan.take).copy_(g)
            g = whole
        if plan.swap is not None:
            split, cat, group = plan.swap
            g = swap_dims(g, cat, split, group)
        for dim, group in plan.scatters:
            g = reduce_scatter_dim(g, dim, group)
        if plan.divide > 1:
            g = g / plan.divide
        return cut(g, plan.slices), None


def gather_block(x: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """The tensor this rank computes with, from its block ``x``: the global
    tensor (``plan.gathers``), or this rank's slice of it where it
    computes only that (``plan.swap`` or ``plan.take``). Differentiable:
    the backward takes the gradient that this rank computed for that
    tensor, reduces it over the ranks as ``plan`` says and returns this
    rank's block of the result."""
    return _GatherBlock.apply(x, plan)
