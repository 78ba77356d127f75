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
one-hot (:func:`repro_torch.models.lm._embed`), and the layout of the
ZeRO-1 gradient accumulator.

A GSPMD layout spreads one tensor over several cards; a single PyTorch
process has no such tensor. So :func:`use_mesh` takes a mesh whose devices
are all one device (``best_mesh(devices=[dev] * k)``, a device listed k
times), on which :func:`shard` and :func:`with_sharding_constraint` check
the spec as ``NamedSharding`` would and return the tensor unchanged, as
``with_sharding_constraint`` returns its value. A mesh over distinct cards
raises ``NotImplementedError`` (multi-card GSPMD: ``ROADMAP.md`` Queue 1
item 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.dist.elastic import Mesh

__all__ = ["P", "NamedSharding", "DuplicateSpecError", "AxisRules",
           "enforce_divisibility", "use_mesh", "current_mesh",
           "current_rules", "shard", "with_sharding_constraint",
           "device_put", "infer_param_specs"]


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
    """The one device every position of ``mesh`` lists; a mesh over
    distinct devices raises ``NotImplementedError``."""
    devs = {str(torch.device(d)) for d in mesh.devices.flat}
    if len(devs) != 1:
        raise NotImplementedError(
            f"a mesh over the distinct devices {sorted(devs)}: GSPMD over "
            "several cards is multi-card GSPMD (ROADMAP.md Queue 1 item 9); "
            "the port's mesh lists one device k times")
    return torch.device(devs.pop())


class use_mesh:
    """``with use_mesh(mesh, rules):`` installs the sharding context, so
    that :func:`shard` checks its specs and the mesh paths take their
    branches. ``mesh`` must list one device (:func:`mesh_device`)."""

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
    ``x``: the mesh lists one device, which holds every shard."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = current_rules().resolve(*axes, mesh=mesh)
    spec = enforce_divisibility(spec, x.shape, mesh)
    return with_sharding_constraint(x, NamedSharding(mesh, spec))


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
    as a constraint's, and each sharded dim must divide by its extent."""
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
        y = x.to(dev)
        if y is x:
            y = x.detach()
        y.sharding = s
        return y
    if isinstance(shardings, NamedSharding):
        return _map_with_path(lambda p, x: put(p, x, shardings), tree)
    return _map_with_path(put, tree, shardings)


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
