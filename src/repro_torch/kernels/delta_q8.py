"""Quantized delta-kernel core (paper Sec. IV-A, Figs. 6/7), the PyTorch and
CUDA port of :mod:`repro.kernels.delta_q8` (both cells).

* :class:`_GruBlockGeometry` — the Fig. 6 block/pad/seam arithmetic every
  packed layout must agree on;
* :func:`pack_cat_volume` — the concatenated-column ``[G, Hp, Ip+Hk]`` pack;
* :class:`QuantDeltaLayout` and :func:`pack_delta_weights_q8` /
  :func:`pack_delta_weights_q4` — int8 codes, or nibble-packed int4 codes
  (:func:`pack_nibbles`), per-gate-row scales and the activation-grid bias;
* :func:`deltagru_q8_step` / :func:`deltalstm_q8_step` — the int8/int4
  GRU (3 gate rows) and LSTM (4 gate rows, saturating Q8.8 cell state)
  layer steps: the CUDA kernels in ``csrc/delta_q8.cu`` for CUDA tensors,
  their plain versions :func:`deltagru_q8_step_ref` /
  :func:`deltalstm_q8_step_ref` for CPU tensors. ``buffered=True`` launches
  the buffered twin of either kernel (the same bits). The kernels compact
  the fired column blocks themselves, on the device (the JAX package's
  ``_prep_step_operands`` prologue); the plain versions multiply every
  column, and the unfired ones add exact zeros;
* :func:`q8_launch_plan` — how a step launches (instance, streams a pass,
  ring stages, shared memory), computed on the host once per geometry and
  cached.

Fixed-point semantics: deltas arrive on the Q8.8 grid, so every
``delta x code`` product and every partial sum is an exact fp32 value; the
delta memories ``M`` hold unscaled code-domain sums, so any summation order
(the kernel's, the plain version's, the JAX package's) gives the same bits.
The activation stage dequantizes (``b + scale * M``) and walks the Q8.8
input / Q1.4 output LUT grid, rounding ``h`` (and the LSTM's ``c``) back
onto Q8.8.

Packing runs on the CPU whatever the device of the weights, and the result
is moved to that device: CUDA divides by a scalar through its reciprocal,
which would change the scales' last bit and with it the packed codes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields, replace

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (cuda_stream, launches_kernel,
                                     q8_kernel, require)

# Delta memories per layer: the GRU splits its candidate gate across the
# x/h seam (M_r, M_u, M_xc, M_hc — 3 gate rows, 4 memories).
N_MEM = 4


class _GruBlockGeometry:
    """Shared block geometry of the Fig. 6 concatenated layout (mixin over
    a layout carrying ``input_size``, ``hidden_size``, ``block_h``,
    ``block_k``)."""

    @property
    def ip(self) -> int:          # padded input k-extent
        return self.input_size + (-self.input_size) % self.block_k

    @property
    def hk(self) -> int:          # padded hidden k-extent
        return self.hidden_size + (-self.hidden_size) % self.block_k

    @property
    def hp(self) -> int:          # padded hidden (output) extent
        return self.hidden_size + (-self.hidden_size) % self.block_h

    @property
    def nbk_x(self) -> int:
        return self.ip // self.block_k

    @property
    def nbk(self) -> int:
        return (self.ip + self.hk) // self.block_k

    @property
    def nbo(self) -> int:
        return self.hp // self.block_h


def layout_to(layout, device):
    """A copy of a layout dataclass with every tensor field on ``device``."""
    moved = {f.name: getattr(layout, f.name).to(device)
             for f in fields(layout)
             if isinstance(getattr(layout, f.name), torch.Tensor)}
    return replace(layout, **moved)


def pack_cat_volume(w_x: torch.Tensor, w_h: torch.Tensor, gates: int,
                    block_h: int, block_k: int) -> torch.Tensor:
    """The Fig. 6 concatenated-column pack: ``w_x: [gH, I]``,
    ``w_h: [gH, H]`` -> ``[g, Hp, Ip + Hk]`` (gate-major rows, hidden dim
    padded to ``block_h``, input then hidden columns each padded to
    ``block_k``: a block-aligned x/h seam)."""
    i_dim, h_dim = w_x.shape[-1], w_h.shape[-1]
    hp = h_dim + (-h_dim) % block_h
    ip = i_dim + (-i_dim) % block_k
    hk = h_dim + (-h_dim) % block_k
    wxg = F.pad(w_x.reshape(gates, h_dim, i_dim),
                (0, ip - i_dim, 0, hp - h_dim))
    whg = F.pad(w_h.reshape(gates, h_dim, h_dim),
                (0, hk - h_dim, 0, hp - h_dim))
    return torch.cat([wxg, whg], dim=2)


def pack_nibbles(codes: torch.Tensor, block_k: int) -> torch.Tensor:
    """Pack int4 codes (two per byte) along the last (k) dimension.

    Per k-block: byte ``j`` holds column ``j`` in its low nibble and column
    ``j + block_k//2`` in its high nibble. ``codes`` are int8 values in
    ``[-8, 7]`` with a last dim divisible by ``block_k``; returns int8 of
    half the last extent (bytes above 127 wrap to negative int8, as in the
    JAX package).
    """
    *lead, k = codes.shape
    if k % block_k:
        raise ValueError(f"pack_nibbles: last dim {k} not a multiple of "
                         f"block_k={block_k}")
    half = block_k // 2
    c = codes.reshape(*lead, k // block_k, 2, half)
    lo = c[..., 0, :].to(torch.int32) & 15
    hi = c[..., 1, :].to(torch.int32) & 15
    return (lo | (hi << 4)).to(torch.int8).reshape(*lead, k // 2)


def unpack_nibbles(packed: torch.Tensor, block_k: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles` (``((n & 15) ^ 8) - 8`` sign
    extension)."""
    *lead, kh = packed.shape
    half = block_k // 2
    p = packed.reshape(*lead, kh // half, half).to(torch.int32)
    lo = ((p & 15) ^ 8) - 8
    hi = (((p >> 4) & 15) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).reshape(*lead, 2 * kh).to(torch.int8)


def _grid_round(v: torch.Tensor, scale: float, vmin: float, vmax: float):
    """Round half-to-even onto a Qm.n grid, then clip (saturate, never
    wrap) — the op sequence of :func:`repro_torch.quant.fake_quant.quantize`
    and of the CUDA kernel's ``grid_round``."""
    q = torch.round(v * scale) / scale
    return torch.clamp(q, vmin, vmax)


@dataclass(frozen=True)
class QuantDeltaLayout(_GruBlockGeometry):
    """One delta-RNN layer packed for the int8 / int4 fused kernel.

    ``w_q`` is the Fig. 6 ``[gates, Hp, Ip + Hk]`` volume as int8 codes
    (``weight_bits=8``), or the nibble-packed ``[gates, Hp, (Ip+Hk)//2]``
    volume (``weight_bits=4``); ``scales: [gates, Hp]`` holds the
    per-gate-row dequant scales; ``b4: [4, Hp]`` the activation-grid bias
    expanded to the four delta memories (``b_r, b_u, b_c, 0``).
    ``w_codes_f32`` is an optional fp32 copy of the codes for the plain
    version on the CPU, built at pack time. The grid constants are Python
    floats fixed at pack time.
    """

    w_q: torch.Tensor
    scales: torch.Tensor
    b4: torch.Tensor
    input_size: int
    hidden_size: int
    block_h: int
    block_k: int
    act_scale: float
    act_min: float
    act_max: float
    lut_scale: float
    lut_min: float
    lut_max: float
    w_codes_f32: torch.Tensor | None = None
    gates: int = 3
    weight_bits: int = 8

    def quantize_act(self, x: torch.Tensor) -> torch.Tensor:
        """Round onto the activation (Q8.8) grid — the Delta Unit's input."""
        return _grid_round(x, *self.act_grid)

    @property
    def act_grid(self) -> tuple:
        """``(scale, min, max)`` of the activation grid, as
        :func:`repro_torch.kernels.ops.delta_unit` takes it."""
        return (self.act_scale, self.act_min, self.act_max)

    def dequantized(self):
        """The matching fp32 fused layout carrying the same quantized
        values (:class:`~repro_torch.kernels.deltagru_seq.FusedGruLayout`
        for ``gates=3``, :class:`~repro_torch.kernels.deltalstm_seq.\
FusedLstmLayout` for ``gates=4``)."""
        if self.gates == 3:
            from repro_torch.kernels.deltagru_seq import FusedGruLayout as Lay
        elif self.gates == 4:
            from repro_torch.kernels.deltalstm_seq import \
                FusedLstmLayout as Lay
        else:
            raise ValueError(f"no fused fp32 layout registered for "
                             f"gates={self.gates}")
        w = _layout_codes_f32(self) * self.scales[:, :, None]
        return Lay(w=w, input_size=self.input_size,
                   hidden_size=self.hidden_size,
                   block_h=self.block_h, block_k=self.block_k)

    def to(self, device) -> "QuantDeltaLayout":
        return layout_to(self, device)


def pack_delta_weights_q8(w_x: torch.Tensor, w_h: torch.Tensor,
                          b: torch.Tensor | None = None, *, gates: int = 3,
                          block_h: int = 128, block_k: int = 128,
                          act_frac_bits: int = 8, act_int_bits: int = 8,
                          lut_frac_bits: int = 4,
                          with_ref_codes: bool | None = None,
                          weight_bits: int = 8) -> QuantDeltaLayout:
    """Quantize + pack one layer into the int8 / int4 Fig. 6 layout.

    Per-gate-row symmetric quantization: ``scale[g, o] = absmax(w[g, o, :])
    / qmax`` over the concatenated (x then h) row, codes rounded half to
    even and clipped to ``[-qmax, qmax]`` (127 at 8 bits, 7 at 4 bits).
    All-zero rows (including Hp padding) get scale ``1/qmax`` and zero
    codes. The bias is rounded onto the activation grid and expanded to the
    four delta memories. Computed on the CPU and returned on the device of
    ``w_x``; ``with_ref_codes=None`` keeps the fp32 code copy only for a
    CPU layout.
    """
    if weight_bits not in (4, 8):
        raise ValueError(
            f"weight_bits must be 4 or 8, got {weight_bits!r} — the packed "
            f"delta pipeline defines only the int8 and nibble-packed int4 "
            f"code grids")
    device = w_x.device
    w_x, w_h = w_x.detach().cpu(), w_h.detach().cpu()
    gh, i_dim = w_x.shape
    h_dim = w_h.shape[-1]
    if gh != gates * h_dim or w_h.shape[0] != gates * h_dim:
        raise ValueError(
            f"pack_delta_weights_q8(gates={gates}) expects w_x [{gates}H, I]"
            f" / w_h [{gates}H, H]; got w_x {tuple(w_x.shape)}, w_h "
            f"{tuple(w_h.shape)} (hidden={h_dim}) — wrong cell family?")
    hp = h_dim + (-h_dim) % block_h
    w3 = pack_cat_volume(w_x.float(), w_h.float(), gates, block_h, block_k)
    qmax = 127.0 if weight_bits == 8 else 7.0
    absmax = torch.amax(torch.abs(w3), dim=2)
    scales = torch.where(absmax > 0, absmax, torch.ones_like(absmax)) / qmax
    codes = torch.clamp(torch.round(w3 / scales[:, :, None]), -qmax, qmax)
    if weight_bits == 8:
        w_q = codes.to(torch.int8)
    else:
        w_q = pack_nibbles(codes.to(torch.int8), block_k)

    act_scale = float(2 ** act_frac_bits)
    act_min = -float(2 ** act_int_bits)
    act_max = float(2 ** act_int_bits) - 1.0 / act_scale
    lut_scale = float(2 ** lut_frac_bits)
    lut_min, lut_max = -2.0, 2.0 - 1.0 / lut_scale     # Q1.n output grid

    if b is None:
        b4 = torch.zeros((N_MEM, hp), dtype=torch.float32)
    else:
        bg = b.detach().cpu().float().reshape(gates, h_dim)
        bg = torch.clamp(torch.round(bg * act_scale) / act_scale,
                         act_min, act_max)
        b4 = F.pad(bg, (0, hp - h_dim, 0, N_MEM - gates))
    if with_ref_codes is None:
        with_ref_codes = device.type == "cpu"
    lay = QuantDeltaLayout(
        w_q=w_q, scales=scales, b4=b4, input_size=i_dim, hidden_size=h_dim,
        block_h=block_h, block_k=block_k,
        act_scale=act_scale, act_min=act_min, act_max=act_max,
        lut_scale=lut_scale, lut_min=lut_min, lut_max=lut_max,
        w_codes_f32=codes if with_ref_codes else None, gates=gates,
        weight_bits=weight_bits)
    return lay.to(device)


def pack_delta_weights_q4(w_x, w_h, b=None, **kw) -> QuantDeltaLayout:
    """The int4 spelling of :func:`pack_delta_weights_q8`: codes in
    ``[-7, 7]``, scale ``absmax/7``, nibble-packed ``w_q``."""
    return pack_delta_weights_q8(w_x, w_h, b, weight_bits=4, **kw)


def _layout_codes_f32(layout: QuantDeltaLayout) -> torch.Tensor:
    """The full (unpacked) fp32 code volume of a layout, any width."""
    if layout.w_codes_f32 is not None:
        return layout.w_codes_f32
    if layout.weight_bits == 4:
        return unpack_nibbles(layout.w_q, layout.block_k).to(torch.float32)
    return layout.w_q.to(torch.float32)


def _ref_code_slices(layout: QuantDeltaLayout):
    """fp32 code views of the x / h column ranges for the plain version."""
    h_dim = layout.hidden_size
    codes = _layout_codes_f32(layout)
    cx = codes[:, :h_dim, :layout.input_size]             # [g, H, I]
    ch = codes[:, :h_dim, layout.ip:layout.ip + h_dim]    # [g, H, H]
    return cx, ch


# ---------------------------------------------------------------------------
# Launching the kernels of csrc/delta_q8.cu
# ---------------------------------------------------------------------------

# What one thread block of an sm_90 card (the kernels' only target) may opt
# in to: 227 KB of dynamic shared memory.
SMEM_OPTIN_BYTES = 232_448
# Constants of csrc/delta_q8.cu and csrc/delta_walk.cuh the plan mirrors.
# The kernel lays out its shared memory itself and refuses a plan whose
# ``smem`` is not exactly its own total, so the two cannot drift apart
# unseen.
Q8_ROWS = 8            # output rows (consumer warps) a block: kRows
Q8_MAX_STREAMS = 8     # streams a pass of the tile instance: kMaxB
Q8_UNROLL = 4          # walk steps a lane has in flight: kUnroll
Q8_INSTANCES = ("one_stream", "tile", "narrow")   # their codes: the index


@dataclass(frozen=True)
class Q8LaunchPlan:
    """How one int8 / int4 step launches (``q8_launch_plan``).

    ``instance``: ``"one_stream"`` (B = 1, one accumulator a lane),
    ``"tile"`` (up to ``Q8_MAX_STREAMS`` streams a pass) or ``"narrow"``
    (block rows that are not a multiple of 16 bytes: 4-byte (int8) or
    2-byte (int4) loads, any B). ``chunk``: streams a pass.
    ``blocks_per_group``: the fired blocks one unrolled group of the walk
    covers (``Q8_UNROLL`` steps a lane, each 8 vectors of a gate row).
    ``stages``: the buffered form's ring (0 unbuffered), one fired block a
    stage. ``fill``: how the buffered form fills a stage (``"none"``
    unbuffered): ``"tensor"``, one tensor copy (16-byte block rows);
    ``"cp.async"``, copies of ``copy_bytes`` (8 or 4, the widest that
    divides the block row and the row stride) spread over the producer
    warp; ``"copy"``, 2-byte loads and shared stores (int4 block rows of 2
    bytes). ``smem``: dynamic shared memory in bytes. ``device``: the CUDA
    device index (-1 for none)."""

    instance: str
    chunk: int
    stages: int
    smem: int
    grid: int
    threads: int
    vector_bytes: int
    blocks_per_group: int
    device: int
    fill: str = "none"
    copy_bytes: int = 0


def _kpad(k: int) -> int:
    """Floats one staged stream takes: 4 of padding after every 16 columns
    (``delta_walk::kpad``)."""
    return k + ((k + 15) >> 4) * 4


def q8_smem_bytes(gates: int, wbk: int, k: int, block_k: int, chunk: int,
                  stages: int, warps: int) -> int:
    """Dynamic shared memory of one launch, laid out as ``smem_layout`` of
    ``csrc/delta_q8.cu``: the ring (stages of a fired block's codes for
    every row and gate, each rounded up to 128 bytes), two mbarriers a
    stage, the staged deltas, the vote words and each warp's fired-block
    list."""
    stage = -(-Q8_ROWS * gates * wbk // 128) * 128
    return (stages * stage + 16 * stages
            + 4 * chunk * _kpad(k) + 4 * ((chunk * (k // 4) + 31) // 32)
            + 4 * warps * (k // block_k))


@functools.lru_cache(maxsize=512)
def q8_launch_plan(gates: int, weight_bits: int, block_k: int, ip: int,
                   k: int, hidden: int, b: int, buffered: bool,
                   device: int = -1) -> Q8LaunchPlan:
    """The launch plan of one int8 / int4 layer step of ``gates`` gate rows
    over ``k = ip + hk`` packed columns, ``b`` streams; computed once per
    geometry, ``b``, ``buffered`` and device and cached, so a launch makes
    no CUDA API query. Raises ``ValueError`` for what no instance takes:
    ``block_k`` not a multiple of 4, or deltas of one stream that do not
    fit ``SMEM_OPTIN_BYTES``."""
    if block_k % 4 or k % block_k or ip % block_k:
        raise ValueError(f"the int8/int4 kernels take block_k a multiple of "
                         f"4 dividing ip={ip} and k={k}; got {block_k}")
    wk = k // 2 if weight_bits == 4 else k
    wbk = block_k // 2 if weight_bits == 4 else block_k
    wide = wbk % 16 == 0
    fill, copy_bytes = "none", 0
    if buffered:
        copy_bytes = next((c for c in (16, 8, 4)
                           if wbk % c == 0 and wk % c == 0), 2)
        fill = {16: "tensor", 2: "copy"}.get(copy_bytes, "cp.async")
    vector = 16 if wide else (4 if weight_bits == 8 else 2)
    per_block = wbk // vector          # vectors a gate row has in a block
    span = 8 * Q8_UNROLL               # vectors a gate's lanes walk a group
    if wide:
        instance = "one_stream" if b == 1 else "tile"
    else:
        instance = "narrow"
    stages = 0
    if buffered:
        need = -(-span // per_block) + (span % per_block != 0)
        stages = max(3, 2 * need)
    warps = Q8_ROWS + int(buffered)
    chunk = 1 if instance == "one_stream" else min(b, Q8_MAX_STREAMS)
    while True:
        smem = q8_smem_bytes(gates, wbk, k, block_k, chunk, stages, warps)
        if smem <= SMEM_OPTIN_BYTES or chunk == 1:
            break
        chunk -= 1
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"one stream's deltas at k={k} need {smem} B of "
                         f"shared memory, more than {SMEM_OPTIN_BYTES}")
    return Q8LaunchPlan(instance=instance, chunk=chunk, stages=stages,
                        smem=smem,
                        grid=-(-hidden // Q8_ROWS), threads=32 * warps,
                        vector_bytes=vector,
                        blocks_per_group=max(1, span // per_block),
                        device=device, fill=fill, copy_bytes=copy_bytes)


def _q8_fn(cell: str):
    """The ``extern "C"`` entry of one cell (``delta_q8_gru_step`` takes
    ``h_prev`` and writes ``m, h``; ``delta_q8_lstm_step`` takes ``c_prev``
    and writes ``m, h, c``)."""
    fn = getattr(_build.load("delta_q8.cu"), f"delta_q8_{cell}_step")
    if fn.argtypes is None:
        n_ptr = 9 if cell == "gru" else 10
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 14
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch_q8(layout: QuantDeltaLayout, gates: int, buffered: bool, m_prev,
               s_prev, dx, dh):
    """Launch the int8 / int4 step of a ``gates``-row layout. ``s_prev`` is
    ``h_prev`` (GRU) or ``c_prev`` (LSTM). Returns ``(m, h)`` or
    ``(m, h, c)``."""
    cell = "gru" if gates == 3 else "lstm"
    if layout.gates != gates:
        raise ValueError(f"the {cell} step needs a {gates}-gate layout, got "
                         f"gates={layout.gates}")
    b, h_dim, i_dim = dx.shape[0], layout.hidden_size, layout.input_size
    k = layout.ip + layout.hk
    index = dx.device.index
    plan = q8_launch_plan(gates, layout.weight_bits, layout.block_k,
                          layout.ip, k, h_dim, b, bool(buffered),
                          -1 if index is None else index)
    wk = k // 2 if layout.weight_bits == 4 else k
    f32 = torch.float32
    require(layout.w_q, "w_q", torch.int8, (gates, layout.hp, wk))
    require(layout.scales, "scales", f32, (gates, layout.hp))
    require(layout.b4, "b4", f32, (N_MEM, layout.hp))
    require(m_prev, "m_prev", f32, (b, N_MEM * h_dim))
    require(s_prev, "h_prev" if gates == 3 else "c_prev", f32, (b, h_dim))
    require(dx, "dx", f32, (b, i_dim))
    require(dh, "dh", f32, (b, h_dim))
    outs = [torch.empty_like(m_prev), torch.empty_like(s_prev)]
    if gates == 4:
        outs.append(torch.empty_like(s_prev))
    err = _q8_fn(cell)(
        layout.w_q.data_ptr(), layout.scales.data_ptr(),
        layout.b4.data_ptr(), m_prev.data_ptr(), s_prev.data_ptr(),
        dx.data_ptr(), dh.data_ptr(), *(o.data_ptr() for o in outs),
        b, i_dim, h_dim, layout.hp, k, layout.ip, layout.block_k,
        layout.weight_bits, int(buffered), Q8_INSTANCES.index(plan.instance),
        plan.chunk, plan.stages, plan.smem, plan.device,
        layout.act_scale, layout.act_min, layout.act_max, layout.lut_scale,
        layout.lut_min, layout.lut_max, cuda_stream(m_prev))
    if err:
        raise RuntimeError(f"delta_q8_{cell}_step launch failed: CUDA error "
                           f"{err}")
    q8_kernel(gates, layout.weight_bits, buffered).launches += 1
    return tuple(outs)


def _act_stage(layout: QuantDeltaLayout):
    """The activation stage's two grid roundings: ``q88`` onto the Q8.8
    activation grid, ``lut`` onto the Q1.n LUT output grid."""
    def q88(v):
        return _grid_round(v, layout.act_scale, layout.act_min,
                           layout.act_max)

    def lut(v):
        return _grid_round(v, layout.lut_scale, layout.lut_min,
                           layout.lut_max)

    return q88, lut


# ---------------------------------------------------------------------------
# GRU layer step (gates=3, seam-routed split-candidate memories)
# ---------------------------------------------------------------------------

def deltagru_q8_step(layout: QuantDeltaLayout, m_prev: torch.Tensor,
                     h_prev: torch.Tensor, dx: torch.Tensor,
                     dh: torch.Tensor, *, buffered: bool = False):
    """One int8 / int4 fused GRU layer step on encoded deltas.

    ``m_prev: [B, 4H]`` (code-domain accumulator), ``h_prev: [B, H]``,
    ``dx: [B, I]``, ``dh: [B, H]`` -> ``(m_new, h_new)``. CUDA operands
    launch the kernel of ``csrc/delta_q8.cu`` (int8 or int4 by
    ``layout.weight_bits``); ``buffered=True`` launches its buffered twin,
    which streams the fired weight blocks through a ring of shared-memory
    stages filled by bulk copies and gives the same bits. CPU operands run
    :func:`deltagru_q8_step_ref` either way (the function is the same).
    """
    if not launches_kernel(layout.w_q, m_prev, h_prev, dx, dh):
        return deltagru_q8_step_ref(layout, m_prev, h_prev, dx, dh)
    return _launch_q8(layout, 3, buffered, m_prev, h_prev, dx, dh)


def deltagru_q8_step_ref(layout: QuantDeltaLayout, m_prev: torch.Tensor,
                         h_prev: torch.Tensor, dx: torch.Tensor,
                         dh: torch.Tensor):
    """Plain PyTorch version of the int8 / int4 GRU step (the port of the
    JAX oracle ``deltagru_q8_step_ref``).

    Bit-identical to the kernel: the code-domain products and sums are
    exact in fp32, so the summation order cannot matter, and the
    dequant/LUT stage runs the same pointwise op sequence. On a CUDA
    device this holds only with TF32 off for matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.set_float32_matmul_precision("highest")``; TF32 would
    truncate the deltas); those are PyTorch's defaults.
    """
    b = dx.shape[0]
    h_dim = layout.hidden_size
    cx, ch = _ref_code_slices(layout)
    px = torch.einsum("bi,ghi->bgh", dx.to(torch.float32), cx)
    ph = torch.einsum("bi,ghi->bgh", dh.to(torch.float32), ch)
    m = m_prev.reshape(b, N_MEM, h_dim).to(torch.float32)
    m_r = m[:, 0] + (px[:, 0] + ph[:, 0])
    m_u = m[:, 1] + (px[:, 1] + ph[:, 1])
    m_xc = m[:, 2] + px[:, 2]
    m_hc = m[:, 3] + ph[:, 2]
    q88, lut = _act_stage(layout)
    s = layout.scales[:, :h_dim]
    b4 = layout.b4[:, :h_dim]
    sc_r = b4[0] + m_r * s[0]
    sc_u = b4[1] + m_u * s[1]
    sc_xc = b4[2] + m_xc * s[2]
    sc_hc = b4[3] + m_hc * s[2]
    r = lut(torch.sigmoid(q88(sc_r)))
    u = lut(torch.sigmoid(q88(sc_u)))
    c = lut(torch.tanh(q88(sc_xc + r * sc_hc)))
    h_new = q88((1.0 - u) * c + u * h_prev.to(torch.float32))
    m_new = torch.stack([m_r, m_u, m_xc, m_hc], 1).reshape(b, N_MEM * h_dim)
    return m_new.to(m_prev.dtype), h_new.to(h_prev.dtype)


# ---------------------------------------------------------------------------
# LSTM layer step (gates=4, no seam routing, saturating Q8.8 cell state)
# ---------------------------------------------------------------------------

def deltalstm_q8_step(layout: QuantDeltaLayout, m_prev: torch.Tensor,
                      h_prev: torch.Tensor, c_prev: torch.Tensor,
                      dx: torch.Tensor, dh: torch.Tensor, *,
                      buffered: bool = False):
    """One int8 / int4 fused LSTM layer step on encoded deltas.

    ``m_prev: [B, 4H]`` (code-domain accumulator), ``c_prev: [B, H]`` (on
    the Q8.8 grid), ``dx: [B, I]``, ``dh: [B, H]`` ->
    ``(m_new, h_new, c_new)``. ``h_prev`` keeps the JAX signature: the
    update ``h = o * tanh(c)`` never reads it, so the kernel is not handed
    it. CUDA operands launch the LSTM kernel of ``csrc/delta_q8.cu``
    (``buffered=True``: its buffered twin, the same bits); CPU
    operands run :func:`deltalstm_q8_step_ref`.
    """
    if not launches_kernel(layout.w_q, m_prev, h_prev, c_prev, dx, dh):
        return deltalstm_q8_step_ref(layout, m_prev, h_prev, c_prev, dx, dh)
    return _launch_q8(layout, 4, buffered, m_prev, c_prev, dx, dh)


def deltalstm_q8_step_ref(layout: QuantDeltaLayout, m_prev: torch.Tensor,
                          h_prev: torch.Tensor, c_prev: torch.Tensor,
                          dx: torch.Tensor, dh: torch.Tensor):
    """Plain PyTorch version of the int8 / int4 LSTM step (the port of the
    JAX oracle ``deltalstm_q8_step_ref``): exact code-domain sums, then
    ``i, f, o = lut(sigmoid(q88(b + s·M)))``, ``g = lut(tanh(q88(·)))``,
    ``c = q88(f·c_prev + i·g)`` (saturating at the Q8.8 rails) and
    ``h = q88(o·lut(tanh(c)))``. Bit-identical to the kernel, under the
    same TF32 condition as :func:`deltagru_q8_step_ref`."""
    b = dx.shape[0]
    h_dim = layout.hidden_size
    cx, ch = _ref_code_slices(layout)
    px = torch.einsum("bi,ghi->bgh", dx.to(torch.float32), cx)
    ph = torch.einsum("bi,ghi->bgh", dh.to(torch.float32), ch)
    m = m_prev.reshape(b, N_MEM, h_dim).to(torch.float32) + (px + ph)
    q88, lut = _act_stage(layout)
    s = layout.scales[:, :h_dim]
    b4 = layout.b4[:, :h_dim]
    gi = lut(torch.sigmoid(q88(b4[0] + m[:, 0] * s[0])))
    gf = lut(torch.sigmoid(q88(b4[1] + m[:, 1] * s[1])))
    gg = lut(torch.tanh(q88(b4[2] + m[:, 2] * s[2])))
    go = lut(torch.sigmoid(q88(b4[3] + m[:, 3] * s[3])))
    c_new = q88(gf * c_prev.to(torch.float32) + gi * gg)
    h_new = q88(go * lut(torch.tanh(c_new)))
    return (m.reshape(b, N_MEM * h_dim).to(m_prev.dtype),
            h_new.to(h_prev.dtype), c_new.to(c_prev.dtype))


# ---------------------------------------------------------------------------
# Exhaustive check of the kernel's activation stage
# ---------------------------------------------------------------------------

def _act_grid_codes(layout: QuantDeltaLayout) -> tuple[int, int]:
    lo = round(layout.act_min * layout.act_scale)
    hi = round(layout.act_max * layout.act_scale)
    return lo, hi - lo + 1


def lut_activation_grid(layout: QuantDeltaLayout, device):
    """``(lut(sigmoid(x)), lut(tanh(x)))`` for every point ``x`` of the
    layout's activation grid (all 2**17 Q8.8 values), computed by the CUDA
    kernel's own device functions on a CUDA ``device`` and by
    :func:`lut_activation_grid_ref` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return lut_activation_grid_ref(layout)
    lo, n = _act_grid_codes(layout)
    sig = torch.empty(n, dtype=torch.float32, device=device)
    tnh = torch.empty(n, dtype=torch.float32, device=device)
    fn = _build.load("delta_q8.cu").delta_q8_act_grid
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(sig.data_ptr(), tnh.data_ptr(), n, lo, layout.act_scale,
             layout.act_min, layout.act_max, layout.lut_scale,
             layout.lut_min, layout.lut_max, cuda_stream(sig))
    if err:
        raise RuntimeError(f"delta_q8_act_grid launch failed: CUDA error "
                           f"{err}")
    return sig, tnh


def lut_activation_grid_ref(layout: QuantDeltaLayout):
    """Plain version of :func:`lut_activation_grid` (the activation stage
    of :func:`deltagru_q8_step_ref` over the whole input grid)."""
    lo, n = _act_grid_codes(layout)
    x = torch.arange(lo, lo + n, dtype=torch.float32) / layout.act_scale
    _, lut = _act_stage(layout)
    return lut(torch.sigmoid(x)), lut(torch.tanh(x))
