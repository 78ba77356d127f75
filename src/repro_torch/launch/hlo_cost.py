"""Per-step cost counter, the PyTorch counterpart of
:mod:`repro.launch.hlo_cost` (it keeps the module name so that a reader
finds the counterpart; there is no HLO here).

The reference walks the optimized HLO text, multiplying each while body by
its known trip count, because XLA's ``cost_analysis`` counts a loop body
once. The port's program runs eagerly, so its loops already count once per
trip: :func:`step_costs` runs the step and counts every aten op it
dispatches, through one ``TorchDispatchMode``:

* FLOPs by the formulas of ``torch.utils.flop_counter`` (the registry
  ``FlopCounterMode`` reads: matmuls, convolutions, attention; 2 x the
  multiply-adds, as the reference counts its dots);
* HBM traffic, the no-fusion bound: the bytes of every operand and result
  of every op that moves data (views and allocations move none; a gather
  reads only the rows it picks and a scatter read-modify-writes only its
  update, as in the reference);
* the core traffic, the same without the elementwise and layout ops of
  :data:`_ELEMENTWISE` and :data:`_LAYOUT_OPS`, about the perfect-fusion
  bound;
* ``peak_live_bytes``: the highest sum of the storages the step allocated
  and still held (its arguments not included), on any device, the meta
  device too.

One loop is not run trip by trip on the meta device: the plain scans' loop
over time (``kernels/ops.py::scan_trips``) runs one trip whose ops count
``T`` times, as the reference's walker multiplies a loop body.

Two of the reference's outputs have no counterpart, and are ``None``:

* ``collective_bytes_per_device`` and ``collectives``: the step counted
  here runs in one process over a mesh that lists one device, and issues
  no collective (GSPMD over several cards in one process is ``ROADMAP.md``
  Queue 1, "Multi-card GSPMD"). A step on a mesh over ranks, one process
  a card (``repro_torch.dist.ranks``), does issue collectives, the data
  group's all-reduce of the gradients among them; the dry-run does not
  count them;
* ``cpu_bf16_upcast_bytes``: an artifact of XLA's CPU backend, which has
  no counterpart in an eager PyTorch program.

Every ``*_per_device`` number is the step's global count divided by the
active mesh's size (``dist.sharding.use_mesh``; 1 without one): the
partitioned program would split the work evenly.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.sharding import current_mesh
from repro_torch.kernels.ops import trip_count

# elementwise ops: a fused program folds them into their neighbours. The
# core traffic leaves them out (in-place and backward forms included)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "exp",
    "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "sqrt",
    "rsqrt", "neg", "abs", "sign", "where", "eq", "ne", "lt", "le", "gt",
    "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "clamp",
    "clamp_min", "clamp_max", "floor", "ceil", "round", "trunc", "cos",
    "sin", "remainder", "fmod", "erf", "erfinv", "atan2", "isfinite",
    "reciprocal", "square", "lerp", "addcmul", "addcdiv", "masked_fill",
    "silu", "gelu", "relu", "softplus", "silu_backward", "gelu_backward",
    "sigmoid_backward", "tanh_backward", "threshold_backward",
    "softplus_backward", "nan_to_num", "hypot", "xlogy",
}

# layout and fill ops: copies, dtype conversions, materialised
# transposes and broadcasts, constant fills
_LAYOUT_OPS = {
    "copy", "clone", "_to_copy", "contiguous", "_unsafe_view", "view",
    "reshape", "transpose", "t", "permute", "expand", "expand_copy",
    "fill", "zero", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "arange",
    "scalar_tensor", "lift_fresh", "lift_fresh_copy", "alias",
}

# allocations and host reads: no traffic
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "_local_scalar_dense",
               "resize_"}

# ops that read only the rows they pick: twice the result's bytes
_GATHER = {"embedding", "index_select", "gather", "index", "take"}

# ops that read-modify-write only their update: twice the update's bytes
# (the position of the update among the op's arguments)
_SCATTER = {"index_put": 2, "_index_put_impl": 2, "scatter": 3,
            "scatter_add": 3, "scatter_reduce": 3, "index_add": 3,
            "index_copy": 3, "masked_scatter": 2, "slice_scatter": 1,
            "select_scatter": 1, "embedding_dense_backward": 0}


def _tensors(x, acc: list) -> list:
    """The tensors of an op's arguments or result (lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, acc)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, acc)
    return acc


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _base(name: str) -> str:
    """``add_`` -> ``add``: an in-place op counts as its functional form."""
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.traffic_core = 0
        self.live = 0
        self.peak = 0
        self._held = {}

    def _free(self, key: int, nbytes: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        trips = trip_count()
        packet = func.overloadpacket
        if packet in flop_registry:
            # an overload with an output type (``bmm.dtype``) counts as
            # the product it is: its type argument is no operand's shape
            fargs = [a for a in args if not isinstance(a, torch.dtype)]
            self.flops += trips * flop_registry[packet](*fargs, **kwargs,
                                                        out_val=out)
        name = _base(packet.__name__)
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if getattr(func, "is_view", False) or name in _NO_TRAFFIC:
            moved = 0
        elif name in _GATHER:
            moved = 2 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTER:
            pos = _SCATTER[name]
            upd = args[pos] if pos < len(args) else None
            moved = 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                         else sum(_nbytes(t) for t in outs))
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                       for t in outs)
        self.traffic += trips * moved
        if name not in _ELEMENTWISE and name not in _LAYOUT_OPS:
            self.traffic_core += trips * moved
        # storages this op allocated: not an operand's, not seen yet
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._held:
                continue
            size = st.nbytes()
            self._held[key] = size
            self.live += size
            weakref.finalize(st, self._free, key, size)
        self.peak = max(self.peak, self.live)
        return out


def step_costs(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` and count its costs (the keys of the
    reference's ``module_costs``, and ``peak_live_bytes``).

    ``flops_per_device``, ``hbm_traffic_per_device`` and
    ``hbm_traffic_core_per_device`` are the step's global counts divided
    by the active mesh's size (1 without a mesh); ``peak_live_bytes`` is
    the step's own, global. ``fn``'s result is dropped."""
    mode = _CostMode()
    with mode:
        fn(*args, **kw)
    mesh = current_mesh()
    size = mesh.size if mesh is not None else 1
    return {
        "flops_per_device": mode.flops / size,
        "hbm_traffic_per_device": mode.traffic / size,
        "hbm_traffic_core_per_device": mode.traffic_core / size,
        "collective_bytes_per_device": None,
        "collectives": None,
        "peak_live_bytes": mode.peak,
    }
