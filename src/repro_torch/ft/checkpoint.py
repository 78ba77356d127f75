"""Checkpointing: tensor-tree save/restore with async write, atomic publish
and an integrity manifest, the PyTorch port of :mod:`repro.ft.checkpoint`.

Layout (one directory per step), the JAX package's own::

    <dir>/step_000123/
        manifest.json        # leaf paths, dtypes, shapes, checksums
        arr_00000.npy ...    # one file per leaf
    <dir>/LATEST             # atomic pointer file

A leaf's path is spelled as ``jax.tree_util.tree_flatten_with_path`` spells
it, and leaves are listed in its order, so a checkpoint written by either
package restores into the other: a dict's keys (sorted) as the key, a tuple
or list position as the index, a NamedTuple field as ``.name``, and the
single child of a :class:`~repro_torch.core.program.DeltaProgramState` (its
stack) as ``0``. For example ``state/0/.layers/1/.x_mem/.memory``.

Leaves are written as host arrays: a tensor is copied to the host before
the write starts, so the write sees the state of the call even when it runs
on a background thread. A state that the ranks hold in blocks (a sharded
train state) is gathered to its global leaves first, leaf by leaf
(:func:`host_state`, which every rank calls): the files hold global leaves
in the same format, and restore over any number of ranks. The write
publishes atomically through a directory rename; a crash mid-write never
corrupts ``LATEST``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.program import DeltaProgramState
from repro_torch.dist.ranks import axis_group, gather_dim
from repro_torch.dist.sharding import _map_with_path as _map_pairs
from repro_torch.dist.sharding import device_put, sharded_dims
from repro_torch.kernels.ops import resolve_device


@dataclass
class WriteHandle:
    """Tracks one (possibly background) checkpoint write.

    ``event`` is set when the write finishes, successfully or not; a failed
    write records its exception in ``error``, and
    :meth:`CheckpointManager.wait` re-raises it on the caller's thread.
    """

    event: threading.Event
    error: BaseException | None = None
    path: str | None = None


def _map_with_path(fn, tree, path: str = ""):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``,
    visiting the leaves in ``tree_flatten_with_path``'s order. Containers:
    dict, NamedTuple, tuple, list, ``DeltaProgramState`` (and ``None``, an
    empty subtree); anything else is a leaf."""
    def sub(key, node):
        return _map_with_path(fn, node, f"{path}/{key}" if path else key)

    if isinstance(tree, DeltaProgramState):
        return replace(tree, stack=sub("0", tree.stack))
    if isinstance(tree, dict):
        done = {k: sub(str(k), tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[sub("." + name, v)
                            for name, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(str(i), v) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_paths(tree) -> list:
    """``[(path, leaf), ...]`` in the order the manifest lists them."""
    out = []
    _map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf (a tensor on any device, or an array)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def host_state(state, shardings, lead: bool = True):
    """The global leaves of ``state`` as host arrays, on the ``lead``
    (None elsewhere). ``shardings``: a tree of ``NamedSharding`` shaped
    like ``state`` (``specs.train_state_sharding``). A leaf that the ranks
    of a mesh over ranks hold in blocks is gathered along each sharded dim
    first (a collective: every rank calls this, in the same order), one
    leaf at a time, so the card never holds a second copy of the whole
    state."""
    def one(_, leaf, sh):
        mesh = sh.mesh
        if mesh.on_ranks:
            for d, names in sharded_dims(sh.spec, mesh):
                leaf = gather_dim(leaf, d, axis_group(mesh, names))
        return _to_host(leaf) if lead else None
    tree = _map_pairs(one, state, shardings)
    return tree if lead else None


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, state, *, async_write: bool = False,
         _done_event: threading.Event | None = None,
         _handle: WriteHandle | None = None) -> str:
    """Save ``state`` (a tree of tensors and arrays) for ``step``. Returns
    the final path (with ``async_write`` the data lands shortly after).

    ``_handle``: a :class:`WriteHandle` to report completion or failure
    through: a background write that throws records the exception there
    (and still sets the event); a synchronous write re-raises at once.
    """
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"

    flat = tree_paths(state)
    paths = [p for p, _ in flat]
    # materialise on the host BEFORE backgrounding (snapshot semantics)
    host_leaves = [_to_host(leaf) for _, leaf in flat]

    def write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": [], "treedef": paths}
        for i, (p, arr) in enumerate(zip(paths, host_leaves)):
            fn = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "path": p, "file": fn, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "sha": _checksum(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    def run_write():
        try:
            write()
            if _handle is not None:
                _handle.path = final
        except BaseException as e:                 # noqa: BLE001
            if _handle is not None:
                _handle.error = e
            else:
                raise
        finally:
            if _handle is not None:
                _handle.event.set()
            if _done_event is not None:
                _done_event.set()

    if async_write:
        threading.Thread(target=run_write, daemon=True).start()
    else:
        run_write()
        if _handle is not None and _handle.error is not None:
            raise _handle.error
    return final


def latest_step(ckpt_dir: str) -> int | None:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def restore(ckpt_dir: str, target_tree, step: int | None = None,
            device=None, verify: bool = True, shardings=None):
    """Restore into the structure of ``target_tree``.

    Every tensor leaf comes back on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``) in the target leaf's dtype; an
    array leaf of the target (host bookkeeping) comes back as a host array
    of its dtype. A path the checkpoint lacks raises ``KeyError``, a
    checksum that does not match ``IOError`` (with ``verify``), a shape
    other than the target's ``ValueError``.

    ``shardings``: a tree of ``NamedSharding`` shaped like the target
    (``specs.train_state_sharding``). Each tensor leaf is then placed by
    ``device_put`` on its sharding's mesh as soon as it is read, in place
    of ``device``: on a mesh over ranks the rank keeps its block, and the
    host holds one global leaf at a time.
    """
    dev = None if shardings is not None else resolve_device(device)
    placing = dict(tree_paths(shardings)) if shardings is not None else {}
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(p, tgt):
        entry = by_path[p]
        arr = np.load(os.path.join(path, entry["file"]))
        if verify and _checksum(arr) != entry["sha"]:
            raise IOError(f"checksum mismatch for {p} in {path}")
        if tuple(arr.shape) != tuple(np.shape(tgt)):
            raise ValueError(
                f"checkpoint leaf {p!r} has logical shape {arr.shape} but "
                f"the restore target expects {tuple(np.shape(tgt))}: the "
                "checkpoint was taken for a different model/engine "
                "configuration")
        # cast to the TARGET dtype: an fp32 save restored onto an int8
        # layout must not flow wrong-width arrays into the kernels
        if isinstance(tgt, torch.Tensor):
            if p in placing:
                return device_put(torch.from_numpy(arr).to(tgt.dtype),
                                  placing[p])
            return torch.from_numpy(arr).to(device=dev, dtype=tgt.dtype)
        return arr.astype(np.asarray(tgt).dtype)

    return _map_with_path(load, target_tree)


def due(step: int, every: int) -> bool:
    """Whether a cadence of a save every ``every`` steps saves at ``step``:
    :meth:`CheckpointManager.maybe_save`'s test, and the one the ranks that
    hold no manager take to gather a state in blocks with the lead
    (:func:`host_state`)."""
    return step % every == 0


class CheckpointManager:
    """Cadence + retention + async orchestration."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3,
                 async_write: bool = True):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.async_write = async_write
        os.makedirs(ckpt_dir, exist_ok=True)
        self._pending: list[WriteHandle] = []

    def maybe_save(self, step: int, state) -> bool:
        """Save ``state`` for ``step`` if the cadence is :func:`due` there."""
        if not due(step, self.every):
            return False
        handle = WriteHandle(threading.Event())
        save(self.dir, step, state, async_write=self.async_write,
             _handle=handle)
        self._pending.append(handle)
        self._gc()
        return True

    def wait(self, timeout: float = 60.0) -> bool:
        """Block until every pending async write has published.

        Returns ``True`` when all pending writes landed; ``False`` when one
        timed out (it stays pending for the next ``wait``). A write that
        failed re-raises its exception here, on the caller's thread.
        """
        still_pending: list[WriteHandle] = []
        first_error: BaseException | None = None
        for handle in self._pending:
            if not handle.event.wait(timeout):
                still_pending.append(handle)
                continue
            if handle.error is not None and first_error is None:
                first_error = handle.error
        self._pending = still_pending
        if first_error is not None:
            raise first_error
        return not still_pending

    def _gc(self):
        steps = sorted(
            int(d.split("_")[-1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
