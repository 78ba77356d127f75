"""The clip's global norm of a gradient tree in one launch.

:func:`repro_torch.train.optim.global_norm` hands the tree's leaves to
:func:`global_norm`. The JAX package computes the same norm as an XLA
fusion inside its jitted train steps (``repro/train/optim.py:60``); there
is no Pallas kernel to port.

CUDA leaves launch ``csrc/global_norm.cu`` once for the whole tree, fp32
and bf16 leaves in one table; CPU (and meta) leaves run
:func:`global_norm_ref`, the ops ``optim.global_norm`` ran before the
kernel. The two differ only in the order of the sum within a leaf: the
kernel sums a leaf's fp32 squares in a fixed order (groups of 8 as an fp32
tree, the groups in double), rounds each leaf's sum to fp32 and adds the
leaves in tree order in fp32, as :func:`global_norm_model` does in plain
ops with an exact sum of each leaf.

With ``squares=True`` each returns the sum of the squares before the
root instead (the kernel writes it beside the norm, from the same launch):
a train state sharded over ranks adds the ranks' sums, then takes the root.

The table (each leaf's pointer, length, dtype word and first chunk) and a
trailing ticket word are written to device memory before the launch: by a
pinned copy on the stream in an eager call, once after the capture in a
CUDA graph (:func:`repro_torch.kernels.ops.device_table`). The kernel
sets the ticket back to 0 at its end, so every replay finds it so.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (GLOBAL_NORM, H100_SMS, cuda_stream,
                                     device_table, launches_kernel,
                                     refuse_autograd)

# Constants of csrc/global_norm.cu.
NORM_THREADS = 256
NORM_GROUP = 8           # elements a thread's group
NORM_GROUPS = 16         # groups a thread a chunk
NORM_SPAN = NORM_THREADS * NORM_GROUP   # elements of a block's groups
NORM_CHUNK = NORM_SPAN * NORM_GROUPS    # elements a chunk
NORM_BLOCKS_PER_SM = 2     # the kernel's launch bounds
# a leaf's row: x, n, item0, bf16
TABLE_WORDS = 4

_DTYPES = (torch.float32, torch.bfloat16)


def norm_table(rows) -> tuple:
    """The kernel's leaf table. ``rows``: per leaf ``(ptr, n, bf16)``.
    Empty leaves are left out (their sum, 0, changes no total). Returns
    ``(table, items)``: an int64 ``[leaves, TABLE_WORDS]`` array and the
    chunks of ``NORM_CHUNK`` elements over all leaves (``item0`` numbers
    each leaf's first)."""
    table, items = [], 0
    for ptr, n, bf16 in rows:
        if n == 0:
            continue
        table.append([ptr, n, items, int(bf16)])
        items += -(-n // NORM_CHUNK)
    return np.array(table, dtype=np.int64).reshape(-1, TABLE_WORDS), items


def norm_items(table: np.ndarray) -> list:
    """What each chunk of the launch sums, read from the table's lengths
    and first chunks alone: ``[(leaf, first element, end), ...]`` in the
    kernel's numbering. No pointer, dtype or grid enters it, so the
    kernel's partition of the sum is a function of the tree's shape."""
    out = []
    for j, (_, n, item0, _) in enumerate(table.tolist()):
        for c in range(-(-n // NORM_CHUNK)):
            assert len(out) == item0 + c
            out.append((j, c * NORM_CHUNK, min(n, (c + 1) * NORM_CHUNK)))
    return out


def thread_groups(c0: int, c1: int, tid: int) -> list:
    """The groups of chunk ``[c0, c1)`` that thread ``tid`` adds, in the
    order it adds them: ``NORM_GROUPS`` groups of ``NORM_GROUP`` elements,
    each two runs of 4 (at ``4 tid`` and ``NORM_SPAN / 2`` later in a
    block's span of ``NORM_SPAN``), as 8-tuples of element indices in the
    order of the group's tree, -1 where past ``c1`` (a square of 0)."""
    out = []
    for b in range(NORM_GROUPS):
        group = []
        for half in (0, NORM_SPAN // 2):
            i = c0 + b * NORM_SPAN + half + 4 * tid
            group.extend(k if k < c1 else -1 for k in range(i, i + 4))
        out.append(tuple(group))
    return out


def norm_grid(items: int) -> int:
    """Blocks of a launch over ``items`` chunks: one a chunk, at most
    ``NORM_BLOCKS_PER_SM`` an SM (a grid-stride loop takes the rest); one
    for an empty tree, whose norm is 0."""
    return max(1, min(items, H100_SMS * NORM_BLOCKS_PER_SM))


def global_norm(leaves, squares: bool = False) -> torch.Tensor:
    """``sqrt`` of the sum over ``leaves`` (a list of fp32 or bf16 tensors)
    of each leaf's squares in fp32: a 0-d fp32 tensor on their device.
    ``squares``: the sum before the root, from the same launch."""
    leaves = list(leaves)
    if not launches_kernel(*leaves):
        return global_norm_ref(leaves, squares)
    refuse_autograd("global_norm", *leaves)
    rows = []
    for j, t in enumerate(leaves):
        if t.dtype not in _DTYPES or not t.is_contiguous():
            raise TypeError(f"global_norm leaf {j}: the kernel takes "
                            f"contiguous fp32 or bf16 tensors, got "
                            f"{t.dtype} (contiguous: {t.is_contiguous()})")
        rows.append((t.data_ptr(), t.numel(), t.dtype == torch.bfloat16))
    table, items = norm_table(rows)
    dev = leaves[0].device
    # the ticket: a word after the table, 0 for the first launch
    words = np.concatenate([table.reshape(-1), np.zeros(1, np.int64)])
    dev_table = device_table(words, dev)
    workspace = torch.empty(max(8, 8 * items + 4 * len(table)),
                            dtype=torch.uint8, device=dev)
    out = torch.empty(2 if squares else 1, dtype=torch.float32, device=dev)
    err = _fn()(dev_table.data_ptr(), len(table), items,
                workspace.data_ptr(), out.data_ptr(),
                out[1].data_ptr() if squares else None, norm_grid(items),
                cuda_stream(out))
    if err:
        raise RuntimeError(f"{GLOBAL_NORM.name} launch failed: CUDA error "
                           f"{err}")
    GLOBAL_NORM.launches += 1
    return out[1] if squares else out[0]


def _fn():
    fn = _build.load("global_norm.cu").global_norm
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ctypes.c_longlong, vp, vp, vp, ci, vp]
        fn.restype = ctypes.c_int
    return fn


def global_norm_ref(leaves, squares: bool = False) -> torch.Tensor:
    """Plain version: the ops ``optim.global_norm`` ran before the kernel
    (the JAX package's order): each leaf cast to fp32, squared and summed,
    the sums added over the leaves in order, the root taken (not with
    ``squares``)."""
    total = sum(torch.sum(torch.square(leaf.to(torch.float32)))
                for leaf in leaves)
    return total if squares else torch.sqrt(total)


def global_norm_model(leaves) -> torch.Tensor:
    """The kernel's order in plain ops: each leaf's fp32 squares summed in
    float64, rounded to fp32; the leaf sums added in order in fp32; the
    correctly rounded fp32 root. Differs from the kernel only where a
    leaf's sum, taken in the kernel's order (groups of 8 squares rounded
    in fp32, at most 3 roundings of 2**-24 each), rounds to another
    fp32."""
    total = None
    for leaf in leaves:
        s = torch.square(leaf.to(torch.float32)).to(torch.float64).sum()
        s = s.to(torch.float32)
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total.to(torch.float64)).to(torch.float32)
