"""Logical-axis sharding rules, the PyTorch port of
:mod:`repro.dist.sharding`.

Model code annotates tensors with *logical* axis names
(``shard(x, "batch", "seq", "embed")``); an :class:`AxisRules` table maps
each logical name to zero or more *mesh* axis names. Mesh axes that the
active mesh does not have are dropped, so the same code runs on a
``("data",)``, a ``("data", "model")`` and a ``("pod", "data", "model")``
mesh unchanged.

The active (mesh, rules) pair is installed with :func:`use_mesh`; with no
context installed every helper is a no-op. The rules decide what the mesh
paths do: whether ``moe_apply_auto`` takes the expert-parallel dispatch
(:mod:`repro_torch.models.moe_ep`), whether the embedding contracts a
one-hot (:func:`repro_torch.models.lm._embed`), the layout of the ZeRO-1
gradient accumulator, and which work the ranks split.

A GSPMD layout spreads one tensor over several cards; a single PyTorch
process has no such tensor. So :func:`use_mesh` takes one of two meshes.
A mesh whose devices are all one device (``best_mesh(devices=[dev] * k)``,
a device listed k times) runs every position in this process, and
:func:`shard` and :func:`with_sharding_constraint` check the spec as
``NamedSharding`` would and return the tensor unchanged, as
``with_sharding_constraint`` returns its value. A mesh over ranks
(``best_mesh()`` after :func:`repro_torch.dist.ranks.init_ranks`) runs one
process a position: each rank holds its block of a sharded tensor
(:func:`device_put`), and the mesh paths issue the collectives that GSPMD
would. A mesh over distinct devices within one process raises
``NotImplementedError`` (``ROADMAP.md`` Queue 1, "Multi-card GSPMD").

On a mesh over ranks the teacher-forced forward splits the work of the
dense layers over the mesh axes that the ``heads``, ``kv_heads``, ``ff``
and ``vocab`` rules name (``model``), as the reference's annotations make
GSPMD split it: each rank computes its own query and key / value heads,
its own FFN columns and its own vocabulary slice of the embedding, the
logits and the loss, and the model code issues the sums GSPMD inserts
(``ranks.psum_grads`` on the way in, ``ranks.psum_disjoint`` on the way
out). :func:`split_extent` is the extent of such a split for a dim of a
given size: 1 where the extent does not divide the dim, as the reference's
:func:`enforce_divisibility` keeps such a dim whole, and 1 on a mesh that
lists one device. A parameter leaf's part in the split is a
:class:`Split`, which the model code gives beside the parameters.

A train state laid out over the ranks (FSDP parameters, ZeRO-1 moments)
holds blocks; the model reads global tensors, or the rank's slice where it
computes only that. :func:`gather_tree` gathers a subtree of blocks at use
(``ranks.gather_block``), and the backward of each gather reduce-scatters
the gradient into the block (:func:`block_plan`). GSPMD inserts the same
collectives into the reference's jitted step. A ``model`` dim that the
rank computes its slice of is not gathered: where the layout shards that
dim over ``model`` the block is the slice already; where it shards
another dim over ``model`` (the row-parallel ``w_o`` and ``w_down``, whose
output dim the layout puts on ``model``) one all-to-all over ``model``
trades the rank's columns for its rows (``ranks.swap_dims``), and its
backward trades the gradient back; where it shards none, the rank cuts
its slice, and the gradient, zero elsewhere, is summed over ``model``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.dist.elastic import Mesh
from repro_torch.dist.ranks import BlockPlan, axis_group, cut, gather_block

__all__ = ["P", "NamedSharding", "DuplicateSpecError", "AxisRules",
           "enforce_divisibility", "use_mesh", "current_mesh",
           "current_rules", "shard", "with_sharding_constraint",
           "device_put", "infer_param_specs", "EXPERT_LEAVES",
           "expert_parallel_leaf", "sharded_dims", "block_shape",
           "global_shape", "Split", "split_extent", "split_names",
           "tp_group", "block_plan", "gather_tree", "replicated_specs"]


class P:
    """A partition spec (``jax.sharding.PartitionSpec``): one entry a
    dimension, each ``None`` (replicated), a mesh axis name, or a tuple of
    names. Iterates, indexes and compares as the tuple of its entries; a
    leaf, not a container, for the tree helpers."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._entries == other._entries
        return isinstance(other, tuple) and self._entries == other

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self._entries)) + ")"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class DuplicateSpecError(Exception):
    """A spec maps one mesh axis to two dimensions (JAX's error of the
    same name)."""


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a spec over its axes (``jax.sharding.NamedSharding``).
    Built, it refuses what JAX's refuses: a mesh axis named twice, or a
    name the mesh does not have."""

    mesh: Mesh
    spec: P

    def __post_init__(self):
        seen = []
        for e in self.spec:
            for n in _names(e):
                if n not in self.mesh.axis_names:
                    raise ValueError(
                        f"Resource axis: {n} of {self.spec} is not found in "
                        f"mesh: {self.mesh.axis_names}.")
                if n in seen:
                    raise DuplicateSpecError(
                        f"A single NamedSharding spec specification can map "
                        f"every mesh axis to at most one positional "
                        f"dimension, but {self.spec} has duplicate entries "
                        f"for `{n}`")
                seen.append(n)


# Logical axis -> mesh axes. "batch" spreads over both pod and data axes
# (pure DP across pods); tensor-ish axes go to the model axis.
_DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "kv_lora": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
}


def _axis_extent(mesh: Mesh, entry) -> int:
    """Total device extent of one spec entry (str | tuple | None)."""
    sizes = mesh.shape
    ext = 1
    for n in _names(entry):
        ext *= sizes.get(n, 1)
    return ext


def _collapse(names: tuple):
    """() -> None, (a,) -> a, (a, b) -> (a, b): the spec entry form."""
    if not names:
        return None
    return names[0] if len(names) == 1 else names


@dataclass(frozen=True)
class AxisRules:
    """Logical-axis -> mesh-axis mapping plus the parameter-FSDP knobs.

    ``embed_fsdp`` is the data-ish axis group used to FSDP-shard the
    *non-model* dimension of 2-D parameters (ZeRO-3 style); ``None`` keeps
    parameters data-replicated (ZeRO-1). ``experts_fsdp`` is the same knob
    for the per-expert weight stacks.
    """

    rules: dict = field(default_factory=lambda: dict(_DEFAULT_RULES))
    embed_fsdp: tuple | None = ("data",)
    experts_fsdp: tuple | None = ("data",)

    def with_overrides(self, **kw) -> "AxisRules":
        """Return a copy with attribute or per-logical-axis overrides."""
        attrs = {}
        new_rules = dict(self.rules)
        for k, v in kw.items():
            if k in ("embed_fsdp", "experts_fsdp"):
                attrs[k] = v
            else:
                new_rules[k] = tuple(v) if v else ()
        return replace(self, rules=new_rules, **attrs)

    def resolve(self, *axes, mesh: Mesh) -> P:
        """Map logical axis names (or ``None``) to a spec, keeping only
        mesh axes that exist on ``mesh``."""
        present = set(mesh.axis_names)
        entries = []
        for a in axes:
            if a is None:
                entries.append(None)
                continue
            names = tuple(n for n in self.rules.get(a, ()) if n in present)
            entries.append(_collapse(names))
        return P(*entries)

    def _present(self, names, mesh: Mesh) -> tuple:
        return tuple(n for n in (names or ()) if n in set(mesh.axis_names))


def enforce_divisibility(spec: P, shape, mesh: Mesh) -> P:
    """Drop spec entries whose mesh extent does not divide the dim size
    (replication instead of GSPMD's pad-and-halo)."""
    out = []
    for d, e in enumerate(spec):
        if e is not None and (d >= len(shape)
                              or shape[d] % _axis_extent(mesh, e) != 0):
            e = None
        out.append(e)
    return P(*out)


# ---------------------------------------------------------------------------
# Active-mesh context
# ---------------------------------------------------------------------------

_CONTEXT: list = []  # stack of (mesh, rules)


def current_mesh() -> Mesh | None:
    return _CONTEXT[-1][0] if _CONTEXT else None


def current_rules() -> AxisRules:
    return _CONTEXT[-1][1] if _CONTEXT else AxisRules()


def mesh_device(mesh: Mesh) -> torch.device:
    """This process's device on ``mesh``: on a mesh over ranks this rank's,
    else the one device every position lists; a mesh over distinct devices
    within one process raises ``NotImplementedError``."""
    if mesh.on_ranks:
        return torch.device(mesh.devices[tuple(mesh.coords().values())])
    devs = {str(torch.device(d)) for d in mesh.devices.flat}
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh over the distinct devices {sorted(devs)} within one "
            "process: GSPMD over several cards in one process is not "
            "ported (ROADMAP.md Queue 1, \"Multi-card GSPMD\"); the port's "
            "mesh lists one device k times, or holds one process a device "
            "(init_ranks, then best_mesh())")
    return torch.device(devs.pop())


class use_mesh:
    """``with use_mesh(mesh, rules):`` installs the sharding context, so
    that :func:`shard` checks its specs and the mesh paths take their
    branches. ``mesh`` lists one device or is a mesh over ranks
    (:func:`mesh_device`)."""

    def __init__(self, mesh: Mesh, rules: AxisRules | None = None):
        mesh_device(mesh)
        self._pair = (mesh, rules or AxisRules())

    def __enter__(self):
        _CONTEXT.append(self._pair)
        return self._pair[0]

    def __exit__(self, *exc):
        _CONTEXT.pop()
        return False


def with_sharding_constraint(x: torch.Tensor, sharding: NamedSharding):
    """``x`` unchanged, after the check JAX makes of a constraint: the spec
    may not be longer than ``x`` has dimensions."""
    if len(sharding.spec) > x.ndim:
        raise ValueError(
            f"One of with_sharding_constraint arguments is incompatible "
            f"with its sharding annotation {sharding.spec}: a spec of "
            f"{len(sharding.spec)} entries for a tensor of rank {x.ndim}")
    return x


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain ``x`` to the resolved logical sharding (no-op without a
    mesh; entries that don't divide fall back to replicated). Returns
    ``x``: on a mesh that lists one device that device holds every shard,
    and on a mesh over ranks ``x`` is already this rank's tensor."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = current_rules().resolve(*axes, mesh=mesh)
    spec = enforce_divisibility(spec, x.shape, mesh)
    return with_sharding_constraint(x, NamedSharding(mesh, spec))


# ---------------------------------------------------------------------------
# The split of the work over the ranks (tensor parallelism)
# ---------------------------------------------------------------------------

def split_names(axis: str, size: int) -> tuple | None:
    """The mesh axes over which the ranks split a dim of ``size`` that the
    model annotates with the logical ``axis`` (``"heads"``, ``"kv_heads"``,
    ``"ff"``, ``"vocab"``): the axes the active rules give it, on the
    active mesh over ranks, where their extent is above 1 and divides
    ``size``; else None. Axes that hold the ``batch`` rows raise: the ranks
    of a split hold the same rows."""
    mesh = current_mesh()
    if mesh is None or not mesh.on_ranks:
        return None
    rules = current_rules()
    names = _names(rules.resolve(axis, mesh=mesh)[0])
    ext = _axis_extent(mesh, names)
    if ext <= 1 or size % ext:
        return None
    batch = _names(rules.resolve("batch", mesh=mesh)[0])
    if set(names) & set(batch):
        raise NotImplementedError(
            f"the {axis!r} work split over {names}, which also hold the "
            f"batch rows ({batch})")
    return names


def split_extent(axis: str, size: int) -> int:
    """The number of ranks that split a dim of ``size`` annotated with the
    logical ``axis`` on the active mesh (:func:`split_names`): 1 without a
    mesh over ranks, or where the extent does not divide ``size``."""
    names = split_names(axis, size)
    return 1 if names is None else _axis_extent(current_mesh(), names)


class TpGroup(NamedTuple):
    """A split's ranks: the mesh axes, this rank's slice among ``parts``,
    and the process group."""

    names: tuple
    index: int
    parts: int
    group: object


class Split(NamedTuple):
    """A parameter leaf's part in the work the ranks of ``tp`` split: each
    computes with its slice of dim ``dim`` (counted from the end, so that
    a stacked leaf and its period agree), or, with ``dim`` None, with the
    whole leaf on the split side, so that its gradient there is the rank's
    part, summed over ``tp.names``. The model code reads ``tp`` from its
    leaves' splits: the split is resolved once (``lm.lm_splits``)."""

    dim: int | None
    tp: TpGroup


def tp_group(axis: str, size: int) -> TpGroup | None:
    """:func:`split_names` of ``axis`` with this rank's slice and the
    group, or None where the ranks do not split it."""
    names = split_names(axis, size)
    if names is None:
        return None
    mesh = current_mesh()
    return TpGroup(names, _shard_index(mesh, names),
                   _axis_extent(mesh, names), axis_group(mesh, names))


# ---------------------------------------------------------------------------
# Trees with paths
# ---------------------------------------------------------------------------

def _key_name(key) -> str:
    """The name JAX's ``infer_param_specs`` reads off a path's last key: a
    dict key or a NamedTuple field as itself, a list index as ``[i]``."""
    return f"[{key}]" if isinstance(key, int) else str(key)


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists, tuples
    and NamedTuples (``None`` stays ``None``), rebuilt as it was."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, *(r[i] for r in rest),
                                           path=path + (name,))
                            for i, (name, v) in enumerate(
                                zip(tree._fields, tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, *(r[i] for r in rest),
                                         path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def device_put(tree, shardings):
    """Place every tensor of ``tree`` on the device of its sharding's mesh
    (``shardings``: one :class:`NamedSharding`, or a tree of them shaped
    like ``tree``), as ``jax.device_put``. Each placed tensor is a new
    tensor object (a copy, or a view of the caller's when it already lies
    there) that carries its sharding as ``.sharding``. A spec is checked
    as a constraint's, and each sharded dim must divide by its extent. On
    a mesh over ranks ``x`` is the global tensor and this rank keeps its
    block: along each sharded dim, the slice at its coordinate on the
    entry's mesh axes (row-major over them, as GSPMD numbers the
    shards)."""
    def put(_, x, s):
        dev = mesh_device(s.mesh)
        with_sharding_constraint(x, s)
        for d, e in enumerate(s.spec):
            if x.shape[d] % _axis_extent(s.mesh, e):
                raise ValueError(
                    f"One of device_put args was given the sharding {s.spec}"
                    f", which implies that the global size of its dimension "
                    f"{d} should be divisible by {_axis_extent(s.mesh, e)}, "
                    f"but it is equal to {x.shape[d]} (full shape: "
                    f"{tuple(x.shape)})")
        if s.mesh.on_ranks and sharded_dims(s.spec, s.mesh):
            # the block in storage of its own: a view would keep the
            # global tensor alive
            block = _local_block(x, s)
            y = torch.empty(block.shape, dtype=x.dtype, device=dev)
            y.copy_(block)
        else:
            y = x.to(dev)
            if y is x:
                y = x.detach()
        y.sharding = s
        return y
    if isinstance(shardings, NamedSharding):
        return _map_with_path(lambda p, x: put(p, x, shardings), tree)
    return _map_with_path(put, tree, shardings)


def _shard_index(mesh: Mesh, names) -> int:
    """This rank's shard index over the mesh axes ``names``: its
    coordinates on them taken row-major, as GSPMD numbers the shards."""
    at, i = mesh.coords(), 0
    for name in names:
        i = i * mesh.shape[name] + at[name]
    return i


def shard_cuts(dims, mesh: Mesh) -> tuple:
    """``ranks.cut``'s ``(dim, index, parts)`` for each ``(dim, mesh axis
    names)`` of ``dims``: the slice at this rank's shard index
    (:func:`_shard_index`) of the names' extent."""
    return tuple((d, _shard_index(mesh, n), _axis_extent(mesh, n))
                 for d, n in dims)


def _local_block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``sharding`` (a mesh over
    ranks): a view, each sharded dim cut to the rank's slice."""
    return cut(x, shard_cuts(sharded_dims(sharding.spec, sharding.mesh),
                             sharding.mesh))


def sharded_dims(spec: P, mesh: Mesh) -> list:
    """``[(dim, mesh axis names), ...]``: the dims that ``spec`` spreads
    over more than one position of ``mesh``."""
    return [(d, _names(e)) for d, e in enumerate(spec)
            if _axis_extent(mesh, e) > 1]


def block_shape(shape, spec: P, mesh: Mesh) -> tuple:
    """The shape of one rank's block of a global ``shape`` under ``spec``."""
    shape = list(shape)
    for d, names in sharded_dims(spec, mesh):
        shape[d] //= _axis_extent(mesh, names)
    return tuple(shape)


def global_shape(shape, spec: P, mesh: Mesh) -> tuple:
    """The global shape of a block of ``shape`` under ``spec``."""
    shape = list(shape)
    for d, names in sharded_dims(spec, mesh):
        shape[d] *= _axis_extent(mesh, names)
    return tuple(shape)


# the expert stacks that the expert-parallel dispatch splits over the
# experts axis (repro_torch.models.moe_ep)
EXPERT_LEAVES = ("experts_gate", "experts_up", "experts_down")


def expert_parallel_leaf(path, leaf, ep: int) -> bool:
    """Whether the expert-parallel dispatch splits the experts of this
    parameter leaf (at ``path``; a global tensor, or its shape) over an
    experts extent ``ep``: an expert stack ``[..., E, D, F]`` whose ``E``
    divides by ``ep > 1``, ``moe_apply_auto``'s condition. On a mesh over
    ranks such a leaf's gradient lies on the ranks that run its experts."""
    name = str(path[-1]) if path else ""
    shape = tuple(getattr(leaf, "shape", leaf))
    return (ep > 1 and name in EXPERT_LEAVES and len(shape) >= 3
            and shape[-3] % ep == 0)


def block_plan(path, shape, spec: P, mesh: Mesh, rules: AxisRules,
               split: Split | None = None):
    """``(plan, pending)`` for a leaf of global ``shape`` at ``path`` laid
    out by ``spec`` on a mesh over ranks, which the model computes with as
    ``split`` says (None: whole, off the split side). ``plan``, a
    :class:`~repro_torch.dist.ranks.BlockPlan`, gathers each sharded dim
    but a split dim that the rank computes its slice of: where ``spec``
    shards that dim over the split's axes the block is the slice; where it
    shards another dim over them the plan swaps the two
    (``ranks.swap_dims``); where it shards none the plan cuts the slice.
    Of the leaf's sums over the ranks (below) its backward reduce-scatters
    each whose axes shard a dim (dividing by the data extent once the data
    group's sum is among them), then cuts the other sharded dims to the
    rank's slice: a dim sharded over ``model`` that no split computes
    takes no sum over ``model``, whose ranks compute the same gradient.
    ``pending``: the groups left to sum the block over (an all-reduce
    after the backward, the train step's bucket).

    A leaf's gradient takes these sums after the backward, in order: over
    the experts axes for a stack the expert-parallel dispatch splits
    (:func:`expert_parallel_leaf`); over the split's axes where the rank's
    gradient is its part (a leaf used whole on the split side, or cut to
    the slice); then over the ``batch`` axes, whose sum is divided by
    their extent."""
    dims = sharded_dims(spec, mesh)
    data = _names(rules.resolve("batch", mesh=mesh)[0])
    experts = _names(rules.resolve("experts", mesh=mesh)[0])
    sums = ([experts] if expert_parallel_leaf(
        path, shape, _axis_extent(mesh, experts)) else [])
    held, swap, take = set(), None, ()
    if split is not None:
        names = split.tp.names
        if any(set(n) & set(names) and n != names for _, n in dims):
            raise NotImplementedError(
                f"{'/'.join(map(str, path))}: a layout {spec} that shards a "
                f"dim over part of the split's axes {names}")
        on = [d for d, n in dims if n == names]
        if split.dim is None:
            sums.append(names)
        else:
            d = split.dim % len(shape)
            if d in on:
                held.add(d)
            elif on:
                held.add(on[0])
                swap = (d, on[0], split.tp.group)
            else:
                take = shard_cuts([(d, names)], mesh)
                sums.append(names)
    sums.append(data)
    scatters, pending, done = [], [], set()
    for names in sums:
        d = next((d for d, n in dims if n == names and d not in done
                  and d not in held), None)
        if d is None:
            pending.append(names)
        else:
            scatters.append((d, axis_group(mesh, names)))
            done.add(d)
    dp = _axis_extent(mesh, data)
    plan = BlockPlan(
        gathers=tuple((d, axis_group(mesh, n)) for d, n in dims
                      if d not in held),
        scatters=tuple(scatters),
        divide=dp if data not in pending else 1,
        slices=shard_cuts([(d, n) for d, n in dims
                           if d not in done and d not in held], mesh),
        swap=swap, take=take)
    return plan, tuple(pending)


def gather_tree(blocks, specs, splits=None):
    """What the model computes with, from a subtree of blocks laid out by
    ``specs`` (a tree of :class:`P` shaped like it) on the active mesh over
    ranks: each leaf's global tensor, or its slice where ``splits`` (a tree
    of :class:`Split` or None shaped like it) says the rank computes only
    that, each through ``ranks.gather_block`` (:func:`block_plan`). The
    identity without a mesh, without ``specs``, and for a leaf whose spec
    shards no dim over more than one position (``P()``, or extent 1) and
    that the rank does not cut. A spec that shards a dim on a mesh that
    lists one device raises: such a mesh holds every tensor whole, so a
    state laid out by it would be replicated, not sharded."""
    mesh = current_mesh()
    if mesh is None or specs is None:
        return blocks
    rules = current_rules()

    def one(path, x, spec, split=None):
        if not sharded_dims(spec, mesh) and (split is None
                                             or split.dim is None):
            return x
        if not mesh.on_ranks:
            raise ValueError(
                f"a parameter laid out by {spec} over the mesh {mesh.shape} "
                "that lists one device: a sharded state needs a mesh over "
                "ranks (init_ranks, then best_mesh())")
        shape = global_shape(x.shape, spec, mesh)
        plan, _ = block_plan(path, shape, spec, mesh, rules, split)
        if not plan.gathers and plan.swap is None and not plan.take:
            return x        # the block is what the rank computes with
        return gather_block(x, plan)
    if splits is None:
        return _map_with_path(one, blocks, specs)
    return _map_with_path(one, blocks, specs, splits)


def replicated_specs(tree):
    """A tree of ``P()`` shaped like ``tree``: every leaf whole on every
    rank."""
    return _map_with_path(lambda _, x: P(*([None] * x.ndim)), tree)


# ---------------------------------------------------------------------------
# Parameter spec inference
# ---------------------------------------------------------------------------

def infer_param_specs(params, *, rules: AxisRules | None = None,
                      mesh: Mesh):
    """Path+shape rule for parameter layouts; a tree of :class:`P` shaped
    like ``params`` (tensors of any device, ``meta`` ones too).

    2-D weights put their larger dimension on the model axes and the other
    on the FSDP (data) axes — the megatron-x-ZeRO layout; 1-D params
    replicate; 3-D per-expert stacks (``"expert"`` in the last key) shard
    experts on the expert axes and their embed dim on ``experts_fsdp``.
    Every proposed spec then passes the divisibility filter, so odd shapes
    degrade to replication instead of erroring.
    """
    rules = rules or AxisRules()
    model_ax = _collapse(rules._present(rules.rules.get("heads"), mesh))
    data_ax = _collapse(rules._present(rules.embed_fsdp, mesh))
    exp_ax = _collapse(rules._present(rules.rules.get("experts"), mesh))
    exp_fsdp = _collapse(rules._present(rules.experts_fsdp, mesh))

    def spec_for(path, x):
        shape = tuple(x.shape)
        ndim = len(shape)
        if ndim <= 1:
            return P(*([None] * ndim))
        name = _key_name(path[-1]) if path else ""
        if ndim == 3 and "expert" in name:
            s = P(exp_ax, exp_fsdp, None)
        elif ndim >= 3:
            s = P(*([None] * (ndim - 2) + [data_ax, model_ax]))
        elif shape[-1] >= shape[-2]:
            s = P(data_ax, model_ax)
        else:
            s = P(model_ax, data_ax)
        return enforce_divisibility(s, shape, mesh)

    return _map_with_path(spec_for, params)


def mesh_coords(mesh: Mesh):
    """``(coordinate dict, device)`` of every mesh position, row-major."""
    for idx in np.ndindex(*mesh.devices.shape):
        yield dict(zip(mesh.axis_names, idx)), mesh.devices[idx]
