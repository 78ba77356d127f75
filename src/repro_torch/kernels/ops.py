"""Device resolution, kernel dispatch by tensor device, and launch counts.

The counterpart of :mod:`repro.kernels.ops`. The JAX package picks a Pallas
mode from the default backend (compiled on a TPU, interpreted or the jnp
oracle elsewhere) and has a global ``set_force_ref`` switch. Here the rule
is the tensor's device, and nothing else:

* operands on the CPU run the kernel's plain PyTorch version;
* operands on a CUDA device launch the hand-written kernel, or raise;
* operands on the meta device (shapes and dtypes, no data: the launch
  tooling's abstract structures) run the plain version, which computes
  nothing there but the shapes of its results.

There is no fallback from a failed launch to the plain version and no
global switch that reroutes the main path; callers that want the plain
version on the card call it by name (``*_ref``).

Every kernel wrapper adds one to its :class:`KernelInfo` ``launches`` count
where it launches its kernel, so a run can show that the main path went
through the kernels. A CUDA graph's capture calls the wrappers without
running a kernel and its replays run kernels without calling a wrapper, so
its owner takes the capture's counts back (:func:`take_back_launches`) and
adds them once per replay (:func:`add_launches`).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for (or defaulted to) and no
    card is present — the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: repro_torch runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device: "cuda" means the current one
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def launches_kernel(*tensors: torch.Tensor) -> bool:
    """Dispatch rule: True when every operand lies on one CUDA device
    (launch the kernel), False when every operand lies on the CPU or on
    the meta device (run the plain version). Mixed or other devices
    raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise before a launch that autograd would record: a kernel has no
    backward, and its ``torch.empty`` outputs carry no ``grad_fn``, so a
    gradient through it would be lost without a word. Callers that train
    through the function call its plain version (``*_ref``) by name."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: it is called on operands that require "
            "grad with grad mode on; call its plain version by name to "
            "differentiate through it")


# Streaming multiprocessors of an H100 SXM, for the launch plans.
H100_SMS = 132


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple, align: int = 16) -> torch.Tensor:
    """Check a kernel operand (device, dtype, shape, contiguity, alignment
    to ``align`` bytes) before its pointer is handed to CUDA; raise on
    anything the kernel does not take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
    return t


def aligned16(*tensors) -> bool:
    """True when every tensor given (None skipped) starts on 16 bytes: the
    kernels that also take 4-byte aligned operands pick their 16-byte
    loads by it."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def cuda_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream, for a kernel launched on
    ``t``'s device. A launch goes to the calling thread's current device,
    so ``t`` must live there."""
    current = torch.cuda.current_device()
    if t.device.index != current:
        raise ValueError(f"operands on {t.device} but the current CUDA "
                         f"device is cuda:{current}; call "
                         "torch.cuda.set_device first")
    return torch.cuda.current_stream().cuda_stream


# -- loops over time ----------------------------------------------------------

_TRIPS = [1]


def trip_count() -> int:
    """How many times the op now running stands for: above 1 inside the
    one trip that :func:`scan_trips` runs for a whole loop on the meta
    device (``launch/hlo_cost.py`` multiplies the op's costs by it)."""
    return _TRIPS[-1]


class _trips:
    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        _TRIPS.append(_TRIPS[-1] * self.n)

    def __exit__(self, *exc):
        _TRIPS.pop()
        return False


def scan_trips(step, carry: tuple, seqs: tuple, consts: tuple = (),
               dim: int = 0):
    """The plain scans' loop over time: ``carry, y = step(carry, *(s_t for
    s in seqs), *consts)`` for each index ``t`` of ``seqs``' dim ``dim``.
    Returns ``(ys stacked along dim, carry)``.

    On the meta device (the dry-run's abstract evaluation) one trip runs
    for the whole loop, as the reference's cost walker multiplies a loop
    body by its trip count: its ops count ``T`` times (:func:`trip_count`),
    forward and backward, and the tensors the loop would keep for its
    backward, ``T - 1`` more trips' worth, are held as one meta buffer.
    Elsewhere it is the loop itself."""
    n = seqs[0].shape[dim]
    if seqs[0].device.type == "meta" and n > 1:
        out = _MetaTrips.apply(step, n, dim, len(carry), len(seqs), *carry,
                               *seqs, *consts)
        return out[-1], tuple(out[:-1])
    ys = []
    for t in range(n):
        carry, y = step(carry, *(s.select(dim, t) for s in seqs), *consts)
        ys.append(y)
    return torch.stack(ys, dim), carry


class _MetaTrips(torch.autograd.Function):
    """One trip of :func:`scan_trips` standing for ``n`` on meta tensors."""

    @staticmethod
    def forward(ctx, step, n, dim, n_carry, n_seq, *tensors):
        grad = any(t.requires_grad for t in tensors)
        # past the first trip the carry depends on what requires grad
        ins = [t.detach().requires_grad_(t.requires_grad
                                         or (grad and i < n_carry))
               for i, t in enumerate(tensors)]
        carry = tuple(ins[:n_carry])
        seqs = ins[n_carry:n_carry + n_seq]
        # a trip keeps what it saves but its inputs' slices and constants
        # (the carry it was handed is its predecessor's output)
        own = {t.untyped_storage()._cdata for t in tensors[n_carry:]}
        saved = {}

        def pack(t):
            st = t.untyped_storage()
            if st._cdata not in own:
                saved[st._cdata] = st.nbytes()
            return t

        # the last trip runs beside the other trips' outputs, listed until
        # the stack copies them out (their size from a trip that counts
        # nothing), and is handed a carry of its own: the first one's stays
        # with the caller
        with torch.no_grad(), _trips(0):
            y0 = step(carry, *(s.select(dim, 0) for s in seqs),
                      *ins[n_carry + n_seq:])[1]
        listed = torch.empty(((n - 1) * y0.numel() * y0.element_size(),),
                             dtype=torch.uint8, device="meta")
        del y0
        handed = torch.empty((sum(c.numel() * c.element_size()
                                  for c in carry),),
                             dtype=torch.uint8, device="meta")
        with torch.enable_grad(), _trips(n), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            new_carry, y = step(carry, *(s.select(dim, 0) for s in seqs),
                                *ins[n_carry + n_seq:])
        ctx.n, ctx.dim, ctx.ins, ctx.n_carry = n, dim, ins, n_carry
        ctx.req = [t.requires_grad for t in tensors]
        ctx.outs = (*new_carry, y)
        # the other trips' tensors kept for the backward
        ctx.held = torch.empty(((n - 1) * sum(saved.values()),),
                               dtype=torch.uint8, device="meta")
        with _trips(n):                   # the stack's traffic, a trip each
            torch.stack([y.detach()], dim)
        shape = list(y.shape)
        shape.insert(dim, n)
        ys = y.new_empty(shape)
        del listed, handed
        return (*(c.detach() for c in new_carry), ys)

    @staticmethod
    def backward(ctx, *grads):
        g_outs = [*grads[:-1], grads[-1].select(ctx.dim, 0)]
        pairs = [(o, g) for o, g in zip(ctx.outs, g_outs) if o.requires_grad]
        need = [i for i, t in enumerate(ctx.ins) if t.requires_grad]
        got = [None] * len(ctx.ins)
        if pairs and need:
            with _trips(ctx.n):
                gs = torch.autograd.grad([o for o, _ in pairs],
                                         [ctx.ins[i] for i in need],
                                         [g for _, g in pairs],
                                         allow_unused=True)
            # the loop's backward adds up a gradient a trip for each slice
            # and constant it read: n - 1 additions of each
            with _trips(ctx.n - 1):
                for i, g in zip(need, gs):
                    if g is not None and i >= ctx.n_carry:
                        torch.add(g, g)
            for i, g in zip(need, gs):
                got[i] = g if ctx.req[i] else None
        ctx.held = ctx.outs = ctx.ins = None
        return (None,) * 5 + tuple(got)


@dataclass
class KernelInfo:
    """One hand-written kernel: where its source lives, which TPU kernel
    it replaces, and how many times the wrapper launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


DELTAGRU_SEQ_F32 = KernelInfo(
    "deltagru_seq_f32", "src/repro_torch/csrc/deltagru_seq.cu",
    "src/repro/kernels/deltagru_seq.py:111")
DELTA_Q8_GRU_I8 = KernelInfo(
    "delta_q8_gru_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:407")
DELTA_Q8_GRU_I4 = KernelInfo(
    "delta_q8_gru_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:407")
DELTALSTM_SEQ_F32 = KernelInfo(
    "deltalstm_seq_f32", "src/repro_torch/csrc/deltalstm_seq.cu",
    "src/repro/kernels/deltalstm_seq.py:119")
DELTA_Q8_LSTM_I8 = KernelInfo(
    "delta_q8_lstm_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:749")
DELTA_Q8_LSTM_I4 = KernelInfo(
    "delta_q8_lstm_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:749")
# the buffered instances (the TPU's double-buffered kernels), reached
# through buffered=True
DELTA_Q8_GRU_DBUF_I8 = KernelInfo(
    "delta_q8_gru_dbuf_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:600")
DELTA_Q8_GRU_DBUF_I4 = KernelInfo(
    "delta_q8_gru_dbuf_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:600")
DELTA_Q8_LSTM_DBUF_I8 = KernelInfo(
    "delta_q8_lstm_dbuf_i8", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:874")
DELTA_Q8_LSTM_DBUF_I4 = KernelInfo(
    "delta_q8_lstm_dbuf_i4", "src/repro_torch/csrc/delta_q8.cu",
    "src/repro/kernels/delta_q8.py:874")
# the kernels of the delta-ized LM cells and the composed GRU step
DELTA_SPMV_F32 = KernelInfo(
    "delta_spmv_f32", "src/repro_torch/csrc/delta_spmv.cu",
    "src/repro/kernels/delta_spmv.py:33")
# the bf16-weight instance of the same kernel, reached through delta_spmv
# on bf16 weights
DELTA_SPMV_BF16 = KernelInfo(
    "delta_spmv_bf16", "src/repro_torch/csrc/delta_spmv.cu",
    "src/repro/kernels/delta_spmv.py:33")
RGLRU_SCAN_F32 = KernelInfo(
    "rglru_scan_f32", "src/repro_torch/csrc/rglru_scan.cu",
    "src/repro/kernels/rglru_scan.py:20")
RWKV6_SCAN_F32 = KernelInfo(
    "rwkv6_scan_f32", "src/repro_torch/csrc/rwkv6_scan.cu",
    "src/repro/kernels/rwkv6_scan.py:24")
# the bf16 r, k, v instance of the same kernel, reached through rwkv6_scan
# on bf16 operands (the bf16 RWKV6 models)
RWKV6_SCAN_BF16 = KernelInfo(
    "rwkv6_scan_bf16", "src/repro_torch/csrc/rwkv6_scan.cu",
    "src/repro/kernels/rwkv6_scan.py:24")
DELTAGRU_ACT_F32 = KernelInfo(
    "deltagru_act_f32", "src/repro_torch/csrc/deltagru_cell.cu",
    "src/repro/kernels/deltagru_cell.py:24")
# the engine step's two kernels, which replace no Pallas kernel: the JAX
# package runs Eq. 2 and the step's accounting as XLA fusions inside its
# jitted step (repro/serve/engine.py:468-469)
DELTA_UNIT_F32 = KernelInfo(
    "delta_unit_f32", "src/repro_torch/csrc/delta_unit.cu",
    "none (XLA fusions: src/repro/core/delta.py:55 delta_encode)")
ENGINE_EPILOGUE_F32 = KernelInfo(
    "engine_epilogue_f32", "src/repro_torch/csrc/engine_epilogue.cu",
    "none (XLA fusions: src/repro/serve/engine.py:315 _one_step)")
# the train steps' AdamW update, which replaces no Pallas kernel: the JAX
# package runs it as an XLA fusion inside its jitted steps; one instance a
# parameter dtype (a tree of both launches each once)
_ADAM_FUSION = ("none (XLA fusion: src/repro/train/trainer.py:122,149, "
                "src/repro/launch/train.py:63)")
FUSED_ADAM_F32 = KernelInfo(
    "fused_adam_f32", "src/repro_torch/csrc/fused_adam.cu", _ADAM_FUSION)
FUSED_ADAM_BF16 = KernelInfo(
    "fused_adam_bf16", "src/repro_torch/csrc/fused_adam.cu", _ADAM_FUSION)
# the clip's global norm of the train steps, one instance for fp32 and bf16
# leaves alike: an XLA fusion in the reference's jitted steps too
GLOBAL_NORM = KernelInfo(
    "global_norm", "src/repro_torch/csrc/global_norm.cu",
    "none (XLA fusion: src/repro/train/optim.py:60 global_norm, called at "
    ":67, :76)")
KERNELS = (DELTAGRU_SEQ_F32, DELTA_Q8_GRU_I8, DELTA_Q8_GRU_I4,
           DELTALSTM_SEQ_F32, DELTA_Q8_LSTM_I8, DELTA_Q8_LSTM_I4,
           DELTA_Q8_GRU_DBUF_I8, DELTA_Q8_GRU_DBUF_I4,
           DELTA_Q8_LSTM_DBUF_I8, DELTA_Q8_LSTM_DBUF_I4,
           DELTA_SPMV_F32, DELTA_SPMV_BF16, RGLRU_SCAN_F32, RWKV6_SCAN_F32,
           RWKV6_SCAN_BF16, DELTAGRU_ACT_F32, DELTA_UNIT_F32,
           ENGINE_EPILOGUE_F32, FUSED_ADAM_F32, FUSED_ADAM_BF16,
           GLOBAL_NORM)


def q8_kernel(gates: int, weight_bits: int, buffered: bool) -> KernelInfo:
    """The int8 / int4 kernel instance of a cell (3 gate rows: GRU, 4:
    LSTM), a weight width and the buffered flag."""
    cell = "gru" if gates == 3 else "lstm"
    name = f"delta_q8_{cell}{'_dbuf' if buffered else ''}_i{weight_bits}"
    return next(k for k in KERNELS if k.name == name)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def take_back_launches(before: dict) -> tuple:
    """Set every count back to ``before`` (a :func:`launch_counts`) and
    return what was counted since, as ``((KernelInfo, n), ...)``. A CUDA
    graph capture calls every wrapper of the step once but runs no kernel:
    its counts are taken back, and :func:`add_launches` adds them once per
    replay, when the kernels do run."""
    counted = tuple((k, k.launches - before[k.name]) for k in KERNELS
                    if k.launches != before[k.name])
    for k, n in counted:
        k.launches -= n
    return counted


def add_launches(counted: tuple) -> None:
    """Add the launches of one replay of a captured graph
    (:func:`take_back_launches`)."""
    for k, n in counted:
        k.launches += n


# -- CUDA graphs --------------------------------------------------------------

_AFTER_CAPTURE: list = []     # one record a capture_cuda_graph running

# each capture's arena for the tables its launches read: the fused Adam's
# rows are 96 bytes a leaf, at most two tables a step (one a parameter
# dtype), the global norm's 32 bytes a leaf and its ticket, one a step; the
# engine epilogue's ~9 KB at RWKV6's 240 leaves (32 KB at its 1024-leaf
# limit), one a step of a 16-step chunk graph; 1 MiB holds them all
TABLE_ARENA_BYTES = 1 << 20


def table_after_capture(host: torch.Tensor) -> torch.Tensor:
    """A device tensor that holds ``host`` (a CPU tensor) once the capture
    now running has ended: for what a launch in the graph reads and the
    graph keeps fixed (a kernel's table of pointers). A copy made inside
    the capture would be a node of the graph, run again at every replay;
    so it is made once, after the capture. The tensor is a slice of the
    capture's table arena (``TABLE_ARENA_BYTES``), allocated before the
    capture: a block of the graph's own pool may be one that an
    earlier node of the graph writes at every replay, and a new allocation
    outside that pool is refused while a stream captures. Raises inside any
    other capture (the graph would read a table nobody wrote) and when the
    arena is full."""
    if not _AFTER_CAPTURE:
        raise RuntimeError(
            "a kernel whose table is written after the capture was captured "
            "outside repro_torch.kernels.ops.capture_cuda_graph")
    rec = _AFTER_CAPTURE[-1]
    nbytes = host.numel() * host.element_size()
    start = -(-rec["used"] // 16) * 16
    arena = rec["arena"]
    if start + nbytes > arena.numel():
        raise RuntimeError(
            f"capture_cuda_graph: a table of {nbytes} B does not fit its "
            f"table arena ({arena.numel()} B, {rec['used']} used); raise "
            f"TABLE_ARENA_BYTES")
    rec["used"] = start + nbytes
    dst = arena[start:start + nbytes].view(host.dtype).view(host.shape)
    rec["writes"].append((dst, host))
    return dst


def device_table(words, device) -> torch.Tensor:
    """A kernel's table (a numpy array of words) in device memory: written
    after the capture when one is running (the graph keeps the address,
    :func:`table_after_capture`), else by a pinned copy on the current
    stream now."""
    host = torch.from_numpy(words)
    if torch.cuda.is_current_stream_capturing():
        return table_after_capture(host)
    return host.pin_memory().to(device, non_blocking=True)


def run_aside(device: torch.device, fn, *args) -> None:
    """``fn(*args)`` on a side stream of a CUDA ``device``, which the
    current stream then waits for (directly on the CPU): a warm-up before a
    capture, whose first-use work must not run on the capturing stream."""
    if device.type != "cuda":
        fn(*args)
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)


def capture_cuda_graph(body, pool=None, stream=None):
    """Capture ``body`` (work over fixed buffers, returning its output
    buffers) into a CUDA graph on a side stream, without synchronising the
    host (``torch.cuda.graph`` would). An arena of ``TABLE_ARENA_BYTES``,
    allocated before the capture, holds the tables its launches read
    (:func:`table_after_capture`); their copies go onto the current stream
    after the capture, ahead of any replay, and the arena lives as long as
    the graph. ``pool``: the memory pool id of a live graph to share (a
    private pool of its own by default); ``stream``: the side stream (a new
    one by default; the caching allocator hands a block freed on one
    stream only to work on that stream, so graphs that share a pool reuse
    each other's freed blocks only when captured on one stream). Returns
    ``replay() -> output``: one graph launch, then that output;
    ``replay.pool`` is the id of the graph's memory pool
    (``CUDAGraph.pool()``, as ``torch.cuda.memory_snapshot()`` names a
    segment's pool) and ``replay.split`` the host seconds of the capture's
    body and of its end (the graph's instantiation)."""
    graph = torch.cuda.CUDAGraph()
    arena = torch.empty(TABLE_ARENA_BYTES, dtype=torch.uint8, device="cuda")
    if stream is None:
        stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    rec = {"arena": arena, "used": 0, "writes": []}
    _AFTER_CAPTURE.append(rec)
    # No garbage collection while the stream captures: an object freed in
    # a collection there (an engine dropped in a reference cycle) may
    # destroy its CUDA graphs, which CUDA forbids during a capture, and
    # the capture fails.
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            if pool is None:
                graph.capture_begin()
            else:
                graph.capture_begin(pool=pool)
            t0 = time.perf_counter()
            try:
                out = body()
            finally:
                t1 = time.perf_counter()
                graph.capture_end()
                t2 = time.perf_counter()
    finally:
        if collecting:
            gc.enable()
        _AFTER_CAPTURE.pop()
    torch.cuda.current_stream().wait_stream(stream)
    for dst, host in rec["writes"]:
        dst.copy_(host.pin_memory(), non_blocking=True)

    def replay():
        graph.replay()
        return out

    replay.arena = arena
    replay.pool = tuple(graph.pool())
    replay.split = {"body_s": t1 - t0, "end_s": t2 - t1}
    return replay


# -- the public kernel ops of the JAX package (repro.kernels.ops) ------------
# Each dispatches by the operands' device inside its kernel module; the
# modules import this one, so they are imported here at call time.

def delta_spmv(w: torch.Tensor, dx: torch.Tensor,
               acc: torch.Tensor | None = None, *, block_k: int = 128,
               packed: bool = False,
               out_dim: int | None = None) -> torch.Tensor:
    """Block-column-skipping ``acc + dx @ w.T`` (the paper's sparse MxV);
    :func:`repro_torch.kernels.delta_spmv.delta_spmv`."""
    from repro_torch.kernels.delta_spmv import delta_spmv as _spmv
    return _spmv(w, dx, acc, block_k=block_k, packed=packed,
                 out_dim=out_dim)


def deltagru_act(m_prev: torch.Tensor, zx: torch.Tensor, zh: torch.Tensor,
                 h_prev: torch.Tensor):
    """Fused DeltaGRU pointwise pipeline (paper Fig. 7);
    :func:`repro_torch.kernels.deltagru_cell.deltagru_act`."""
    from repro_torch.kernels.deltagru_cell import deltagru_act as _act
    return _act(m_prev, zx, zh, h_prev)


def rwkv6_scan(r, k, v, w, u, s0=None):
    """WKV6 recurrence over ``[B, H, T, D]``;
    :func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan`."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _scan
    return _scan(r, k, v, w, u, s0)


def rwkv6_chunked(r, k, v, w, u, s0=None, *, chunk: int = 16):
    """Chunk-parallel WKV6 (matmul form, differentiable, plain PyTorch on
    any device): the same function as :func:`rwkv6_scan`. Pads T to a chunk
    multiple with ``w = 1`` and ``k = 0``, which freeze the state."""
    from repro_torch.kernels.ref import rwkv6_chunked_ref
    t = r.shape[2]
    pad = (-t) % chunk
    if pad:
        pd = (0, 0, 0, pad)
        r, k, v = (torch.nn.functional.pad(z, pd) for z in (r, k, v))
        w = torch.nn.functional.pad(w, pd, value=1.0)
    y, s_t = rwkv6_chunked_ref(r, k, v, w, u, s0, chunk=chunk)
    return y[:, :, :t], s_t


def delta_unit(x_streams, h_streams, theta_x, theta_h, *, act_grid=None,
               guard=None):
    """Eq. 2 over a layer step's input and hidden streams in one launch,
    with the firing counts (and the engine's frame guard on layer 0's
    input); :func:`repro_torch.kernels.delta_unit.delta_unit`."""
    from repro_torch.kernels.delta_unit import delta_unit as _du
    return _du(x_streams, h_streams, theta_x, theta_h, act_grid=act_grid,
               guard=guard)


def engine_epilogue(leaves, counts, cols, carry, x, finite, consts,
                    workspace=None):
    """The engine step's non-finite rows, firing fractions, Eq. 5-8 terms
    and carry updates in one launch; :func:`repro_torch.kernels.
    engine_epilogue.engine_epilogue`."""
    from repro_torch.kernels.engine_epilogue import engine_epilogue as _ep
    return _ep(leaves, counts, cols, carry, x, finite, consts, workspace)


def fused_adam(params, grads, mu, nu, *, scale, lr, corr1, corr2, b1,
               b2, eps, weight_decay, out=None):
    """The AdamW update of a tree's leaves in one launch a parameter
    dtype; :func:`repro_torch.kernels.fused_adam.fused_adam`."""
    from repro_torch.kernels.fused_adam import fused_adam as _adam
    return _adam(params, grads, mu, nu, scale=scale, lr=lr, corr1=corr1,
                 corr2=corr2, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, out=out)


def global_norm(leaves, squares: bool = False):
    """``sqrt`` of the sum of every leaf's squares (fp32 and bf16 leaves)
    in one launch, or with ``squares`` the sum before the root;
    :func:`repro_torch.kernels.global_norm.global_norm`."""
    from repro_torch.kernels.global_norm import global_norm as _norm
    return _norm(leaves, squares)


def rglru_scan(x, a, h0=None):
    """RG-LRU diagonal recurrence over ``[B, T, D]``;
    :func:`repro_torch.kernels.rglru_scan.rglru_scan`."""
    from repro_torch.kernels.rglru_scan import rglru_scan as _scan
    return _scan(x, a, h0)


def deltagru_cell_fused(w_x: torch.Tensor, w_h: torch.Tensor,
                        m_prev: torch.Tensor, h_prev: torch.Tensor,
                        dx: torch.Tensor, dh: torch.Tensor):
    """The full DeltaGRU step as the FPGA runs it: two sparse MxVs
    (``w_x: [3H, I]``, ``w_h: [3H, H]``, unpacked) and the activation
    pipeline, three launches on a CUDA device."""
    zx = delta_spmv(w_x, dx)
    zh = delta_spmv(w_h, dh)
    return deltagru_act(m_prev, zx, zh, h_prev)
