"""Feed-forward blocks: gated (SwiGLU / GeGLU) and plain MLPs, the PyTorch
port of :mod:`repro.models.ffn`.

Under a mesh over ranks the teacher-forced forward splits the ``ff``
columns (``ffn_apply(..., tp=)``), as the reference's ``shard(...,
"ff")`` annotations make GSPMD split them: each rank of the ``ff`` group
computes its columns of ``w_up`` / ``w_gate`` and its rows of ``w_down``,
and the output is summed over the group."""
from __future__ import annotations

import torch

from repro_torch.dist.ranks import psum_grads
from repro_torch.dist.sharding import Split, tp_group
from repro_torch.models.common import ACTIVATIONS, dense_init, row_parallel


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(generator, d_model, d_ff, dtype),
         "w_down": dense_init(generator, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype)
    return p


def ffn_splits(params: dict, d_ff: int) -> dict:
    """Each leaf's :class:`~repro_torch.dist.sharding.Split` in
    ``ffn_apply`` on the active mesh (``d_ff``: the global width):
    ``w_up`` / ``w_gate`` by columns and ``w_down`` by rows over the
    ``ff`` group, or None for every leaf where the ranks do not split
    ``ff``."""
    tp = tp_group("ff", d_ff)
    return {k: None if tp is None else Split(-2 if k == "w_down" else -1, tp)
            for k in params}


def ffn_apply(params: dict, x: torch.Tensor, *, activation: str = "silu",
              tp=None) -> torch.Tensor:
    """The block's MLP. ``tp`` (a ``sharding.TpGroup``, the ``ff`` split of
    :func:`ffn_splits`): ``params`` holds this rank's slices; ``x`` goes
    through ``ranks.psum_grads`` and the output through
    ``ranks.psum_disjoint``."""
    act = ACTIVATIONS[activation]
    if tp is not None:
        x = psum_grads(x, tp.group)
    up = x @ params["w_up"]
    h = act(x @ params["w_gate"]) * up if "w_gate" in params else act(up)
    return row_parallel(h, params["w_down"], tp)
