"""The launch plans of the two scans (``rwkv6_scan_plan`` in
``repro_torch/kernels/rwkv6_scan.py``, ``rglru_scan_plan`` in
``repro_torch/kernels/rglru_scan.py``), on the CPU.

Each plan is arithmetic on the call's shape, computed once on the host and
cached, so a launch makes no CUDA API query; the C entries refuse a plan
they cannot run. Walked the way the kernels walk them (a block takes units
``blockIdx, blockIdx + grid, ...``; a thread of ``rwkv6_scan``'s one-step
kernel (T <= 1) owns one key and 4 value columns of its unit, a thread of
its chunked kernel (T > 1) 4 keys of 4 columns, whose sums the 4 lanes
that end with one write together, chunk by chunk of steps; a thread of
``rglru_scan`` 4 channels of one stream), the plans must:

* cover every ``(b, h, key, column)`` of the WKV state, every ``(b, h, t,
  column)`` of its output (written by the 4 lanes that hold its sum, in
  one store), and every ``(b, c)`` of the RG-LRU state exactly once;
* launch no more blocks than the SMs of an H100 hold at once, and give a
  block no more shared memory than it may take (227 KB);
* take the 16-byte path exactly where it is legal: for ``rglru_scan`` when
  ``W % 4 == 0`` and every operand is 16-byte aligned;
* refuse a head size other than 64, negative sizes, and operands that
  are not fp32 (``rwkv6_scan`` also takes bf16 ``r, k, v``);
* be cached, and make no CUDA API call.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import rwkv6_scan as wkv

MAIN_PATH = [(1, 32), (8, 32)]    # (B, H) of the RWKV6 engine and batcher


def _wkv_cover(plan, b, h):
    """How often the kernel's threads touch each state element
    ``[b, h, key, column]`` under ``plan``."""
    seen = np.zeros((b, h, 64, 64), np.int64)
    groups = 64 // plan.cols
    q_count = plan.cols // wkv.RWKV6_VEC
    for block in range(plan.grid):
        for unit in range(block, plan.units, plan.grid):
            bh, c0 = divmod(unit, groups)
            for tid in range(plan.threads):
                i, q = divmod(tid, q_count)
                j = c0 * plan.cols + q * wkv.RWKV6_VEC
                seen[bh // h, bh % h, i, j:j + wkv.RWKV6_VEC] += 1
    return seen


def _wkv_chunk_cover(plan, b, h, t):
    """How often the chunked kernel's threads touch each state element
    ``[b, h, key, column]`` and store to each output ``[b, h, t, column]``
    under ``plan``."""
    state = np.zeros((b, h, 64, 64), np.int64)
    out = np.zeros((b, h, t, 64), np.int64)
    lanes = 64 // wkv.RWKV6_KEYS                  # lanes of a column vector
    tid = np.arange(plan.threads)
    lane, l = tid % 32, tid % 32 % lanes
    j = tid // 32 * (32 // lanes * wkv.RWKV6_VEC) + lane // lanes * 4
    keys = wkv.RWKV6_KEYS * l[:, None] + np.arange(wkv.RWKV6_KEYS)
    cols = j[:, None] + np.arange(wkv.RWKV6_VEC)
    # after the reduce-scatter lane l holds the column of its halves
    y_col = j + 2 * (l // (lanes // 2) % 2) + l // (lanes // 4) % 2
    groups = 64 // plan.cols
    for block in range(plan.grid):
        for unit in range(block, plan.units, plan.grid):
            bh, c0 = divmod(unit, groups)
            sb, sh = divmod(bh, h)
            np.add.at(state[sb, sh], (keys[:, :, None],
                                      c0 * plan.cols + cols[:, None, :]), 1)
            for c in range(-(-t // plan.chunk)):
                steps = c * plan.chunk + np.arange(
                    min(plan.chunk, t - c * plan.chunk))
                np.add.at(out[sb, sh], (steps[:, None],
                                        c0 * plan.cols + y_col[None]), 1)
    return state, out


def _lru_cover(plan, b, w):
    """How often the kernel's threads touch each channel ``[b, c]``."""
    seen = np.zeros((b, w), np.int64)
    stride = plan.grid * plan.threads
    for thread in range(stride):
        for unit in range(thread, plan.units, stride):
            bb, u = divmod(unit, plan.row_units)
            c0 = u * lru.RGLRU_VEC
            seen[bb, c0:min(w, c0 + lru.RGLRU_VEC)] += 1
    return seen


@pytest.mark.parametrize("b,h", MAIN_PATH + [(2, 3), (9, 32), (1, 1)])
def test_rwkv6_plan_covers_every_state_element_once(b, h):
    plan = wkv.rwkv6_scan_plan(b, h, 1, 64)
    assert plan.cols == wkv.RWKV6_COLS == 16
    assert plan.threads == 16 * plan.cols
    assert plan.units == b * h * 64 // plan.cols
    assert (_wkv_cover(plan, b, h) == 1).all()


def test_rwkv6_plan_at_the_main_path_and_its_residency():
    # 16 columns a block: 4 blocks a head, 128 blocks of 256 threads for
    # one stream (132 SMs), one block a unit up to the SMs' 2048 threads
    # (the one-step kernel, T <= 1; the chunked one's residency below)
    assert wkv.RWKV6_THREADS_PER_SM == 2048
    one = wkv.rwkv6_scan_plan(1, 32, 1, 64)
    assert (one.cols, one.threads, one.grid, one.vec) == (16, 256, 128, 4)
    tile = wkv.rwkv6_scan_plan(8, 32, 1, 64)
    assert (tile.grid, tile.units) == (1024, 1024)
    for b in range(1, 20):
        for h in (1, 3, 32):
            plan = wkv.rwkv6_scan_plan(b, h, 1, 64)
            resident = ops.H100_SMS * (2048 // plan.threads)
            assert plan.grid == min(plan.units, resident)
            assert plan.grid <= wkv.rwkv6_resident_blocks(plan.threads)
    # a grid of fewer blocks than units walks them all
    other = wkv.Rwkv6ScanPlan(16, 256, 9 * 3 * 4, 7, 4, -1)
    assert (_wkv_cover(other, 9, 3) == 1).all()


CHUNK = wkv.RWKV6_CHUNK
STORES = 64 // wkv.RWKV6_KEYS // 4  # lanes that store one output together


@pytest.mark.parametrize("t", [2, CHUNK - 1, CHUNK, CHUNK + 1, 37, 128])
@pytest.mark.parametrize("b,h", [(1, 3), (1, 32), (4, 3), (4, 32), (9, 3),
                                 (9, 32)])
def test_rwkv6_chunk_plan_covers_every_state_element_and_step_once(b, h, t):
    """T > 1: the chunked kernel, chunks of ``min(T, RWKV6_CHUNK)`` steps,
    the last one ragged; every state element owned by one thread, every
    output written once, in either type of ``r, k, v``."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = wkv.rwkv6_scan_plan(b, h, t, 64, dtype)
        assert plan.chunk == min(t, CHUNK) and plan.cols in (16, 32, 64)
        assert plan.threads == 4 * plan.cols
        assert plan.units == b * h * 64 // plan.cols
        state, out = _wkv_chunk_cover(plan, b, h, t)
        assert (state == 1).all() and (out == STORES).all()
    # a grid of fewer blocks than units walks them all
    walk = dataclasses.replace(plan, grid=max(1, plan.units // 3))
    state, out = _wkv_chunk_cover(walk, b, h, t)
    assert (state == 1).all() and (out == STORES).all()


def test_rwkv6_chunk_plan_grid_stays_resident_in_shared_memory():
    """The chunked plan's block takes the two buffers of its chunk and a
    spare row (at most 227 KB, 66 KB here) and its grid at most the blocks
    the SMs hold at once: 2 of 256 threads an SM by the launch bounds, as
    many as the SM's 228 KB hold; a whole head a block where that fills
    3/4 of the SMs."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert wkv.RWKV6_CHUNK_COLS == (64, 32, 16)
    for b in (1, 2, 4, 5, 9, 33, 300):
        for h in (1, 3, 32):
            for t in (2, 17, CHUNK, CHUNK + 1, 128, 4096):
                for dtype in (f32, bf16):
                    plan = wkv.rwkv6_scan_plan(b, h, t, 64, dtype)
                    assert plan.smem == wkv.rwkv6_chunk_smem(
                        plan.chunk, plan.cols, dtype)
                    assert plan.smem <= wkv.BLOCK_SHARED_BYTES
                    resident = wkv.rwkv6_chunk_resident_blocks(
                        plan.threads, plan.smem)
                    per_sm = resident // ops.H100_SMS
                    assert per_sm >= 1
                    assert per_sm * (plan.smem + 1024) <= 228 * 1024
                    assert per_sm * plan.threads <= 2 * 256
                    assert plan.grid == min(plan.units, resident)
                    wider = [c for c in wkv.RWKV6_CHUNK_COLS if c > plan.cols]
                    assert all(4 * b * h * 64 // c < 3 * ops.H100_SMS
                               for c in wider)
    # the LM prefill [4, 32, 128, 64]: one head a block, 128 blocks
    for dtype, smem in ((f32, 66 * 1024), (bf16, 33 * 1280)):
        plan = wkv.rwkv6_scan_plan(4, 32, 128, 64, dtype)
        assert (plan.chunk, plan.cols, plan.threads, plan.grid,
                plan.smem) == (32, 64, 256, 128, smem)
    # a chunk's two buffers of 33 rows: 2 x 33 x (256 + 192 x 4) bytes in
    # fp32
    assert wkv.rwkv6_chunk_smem(32, 64, f32) == 2 * 33 * (256 + 192 * 4)
    assert wkv.rwkv6_chunk_smem(32, 64, f32) > wkv.DEFAULT_SHARED_BYTES


@pytest.mark.parametrize("b,h", [(1, 32), (4, 32), (8, 32), (9, 3), (0, 32),
                                 (2000, 32)])
def test_rwkv6_plan_at_one_step_is_the_one_step_kernels(b, h):
    """T <= 1 keeps the one-step kernel's plan: 16 columns a block, 256
    threads, one block a unit up to the SMs' 2048 threads, no chunk and no
    dynamic shared memory."""
    for t in (0, 1):
        for dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                units = b * h * 4
                want = wkv.Rwkv6ScanPlan(
                    cols=16, threads=256, units=units,
                    grid=min(units, ops.H100_SMS * 8),
                    vec=4 if aligned else 1, device=0)
                got = wkv.rwkv6_scan_plan(b, h, t, 64, dtype, aligned, 0)
                assert got == want and (got.chunk, got.smem) == (0, 0)


@pytest.mark.parametrize("b,w", [(1, 4096), (8, 4096), (1, 4094),
                                 (2, 4097), (3, 5), (9, 1), (1, 3)])
def test_rglru_plan_covers_every_channel_once(b, w):
    plan = lru.rglru_scan_plan(b, 1, w)
    assert plan.threads in lru.RGLRU_THREADS
    assert plan.row_units == -(-w // 4) and plan.units == b * plan.row_units
    assert (_lru_cover(plan, b, w) == 1).all()


def test_rglru_plan_grid_stays_resident():
    # 128 threads a block: 8 blocks for one stream at W = 4096, 64 for the
    # 8-slot batcher; at most 16 blocks an SM (its 2048 threads)
    assert lru.RGLRU_PLAN_THREADS == 128
    assert lru.rglru_scan_plan(1, 1, 4096).grid == 8
    assert lru.rglru_scan_plan(8, 1, 4096).grid == 64
    for b in (1, 2, 8, 9, 33, 300, 5000):
        for w in (1, 4094, 4096, 4097):
            plan = lru.rglru_scan_plan(b, 3, w)
            assert plan.threads == 128
            blocks = -(-plan.units // plan.threads)
            resident = ops.H100_SMS * min(32, 2048 // plan.threads)
            assert plan.grid == min(blocks, resident)
            assert plan.grid <= lru.rglru_resident_blocks(plan.threads)
    plan = lru.rglru_scan_plan(5000, 1, 4096)     # more units than threads
    assert plan.grid * plan.threads < plan.units
    assert (_lru_cover(lru.rglru_scan_plan(2000, 1, 12), 2000, 12) == 1).all()


def test_vector_path_exactly_when_width_and_pointers_allow():
    for w in range(1, 40):
        for aligned in (True, False):
            plan = lru.rglru_scan_plan(2, 5, w, torch.float32, aligned)
            assert (plan.vec == 4) == (w % 4 == 0 and aligned)
            assert plan.vec in (1, 4)
    for aligned in (True, False):
        for t in (1, 128):
            plan = wkv.rwkv6_scan_plan(1, 32, t, 64, torch.float32, aligned)
            assert plan.vec == (4 if aligned else 1)


def test_the_wrappers_alignment_test():
    # a contiguous view one float into its buffer is 4- but not 16-byte
    # aligned; the 16-byte path needs every operand (None skipped) aligned
    buf = torch.zeros(4 * 4096 + 4)
    view = buf[1:1 + 4096].view(1, 1, 4096)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert ops.aligned16(buf, None, buf[4:])
    assert not ops.aligned16(buf, view)


def test_refusals():
    for d in (32, 63, 65, 128):
        with pytest.raises(ValueError, match="head size"):
            wkv.rwkv6_scan_plan(1, 32, 1, d)
    for bad in ((1, 32, -1, 64), (-1, 32, 1, 64), (1, -2, 1, 64)):
        with pytest.raises(ValueError, match=">= 0"):
            wkv.rwkv6_scan_plan(*bad)
    for bad in ((1, -1, 4096), (-3, 1, 4096), (1, 1, -4)):
        with pytest.raises(ValueError, match=">= 0"):
            lru.rglru_scan_plan(*bad)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        if dtype != torch.bfloat16:       # rwkv6_scan's bf16 instance
            with pytest.raises(ValueError, match="fp32"):
                wkv.rwkv6_scan_plan(1, 32, 1, 64, dtype)
        with pytest.raises(ValueError, match="fp32"):
            lru.rglru_scan_plan(1, 1, 4096, dtype)
    # zero-sized calls plan no work
    assert wkv.rwkv6_scan_plan(0, 32, 1, 64).units == 0
    assert lru.rglru_scan_plan(1, 0, 4096).units == 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64, torch.int8, torch.float32])
def test_rwkv6_plan_takes_fp32_and_bf16_only(dtype):
    """Row 9b: bf16 r, k, v have a plan, the same walk as fp32's; at
    T > 1 its chunk's buffers hold r, k, v rows of half the bytes, so it
    differs from fp32's in its shared memory alone. Every other type is
    refused."""
    if dtype in (torch.float32, torch.bfloat16):
        plan = wkv.rwkv6_scan_plan(4, 32, 128, 64, dtype)
        f32 = wkv.rwkv6_scan_plan(4, 32, 128, 64, torch.float32)
        assert dataclasses.replace(plan, smem=f32.smem) == f32
        assert plan.smem == wkv.rwkv6_chunk_smem(32, 64, dtype)
        state, out = _wkv_chunk_cover(plan, 4, 32, 128)
        assert (state == 1).all() and (out == STORES).all()
        step = wkv.rwkv6_scan_plan(4, 32, 1, 64, dtype)
        assert step == wkv.rwkv6_scan_plan(4, 32, 1, 64, torch.float32)
        assert (_wkv_cover(step, 4, 32) == 1).all()
    else:
        with pytest.raises(ValueError, match="fp32 or bf16"):
            wkv.rwkv6_scan_plan(4, 32, 128, 64, dtype)


def test_plans_are_cached_and_need_no_cuda_api(monkeypatch):
    a = wkv.rwkv6_scan_plan(1, 32, 1, 64, torch.float32, True, 0)
    assert wkv.rwkv6_scan_plan(1, 32, 1, 64, torch.float32, True, 0) is a
    b = wkv.rwkv6_scan_plan(4, 32, 128, 64, torch.bfloat16, True, 0)
    assert wkv.rwkv6_scan_plan(4, 32, 128, 64, torch.bfloat16, True, 0) is b
    assert wkv.rwkv6_scan_plan(1, 32, 1, 64, torch.float32, True, 1) != a
    assert wkv.rwkv6_scan_plan(1, 32, 1, 64, torch.float32, False, 0) != a
    c = lru.rglru_scan_plan(1, 1, 4096, torch.float32, True, 0)
    assert lru.rglru_scan_plan(1, 1, 4096, torch.float32, True, 0) is c
    assert lru.rglru_scan_plan(1, 1, 4096, torch.float32, False, 0) != c

    def refuse(*args, **kwargs):
        raise AssertionError("the plan queried CUDA")

    for name in ("is_available", "current_device", "get_device_properties",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    plan = wkv.rwkv6_scan_plan.__wrapped__(8, 32, 1, 64, torch.float32,
                                           True, 0)
    assert plan.grid == 1024 and plan.device == 0
    plan = wkv.rwkv6_scan_plan.__wrapped__(4, 32, 128, 64, torch.bfloat16,
                                           True, 0)
    assert plan.chunk == 32 and plan.grid == 128 and plan.device == 0
    plan = lru.rglru_scan_plan.__wrapped__(8, 1, 4097, torch.float32, True,
                                           0)
    assert plan.vec == 1 and plan.grid == 65


class _FakeScanLib:
    """``rwkv6_scan.cu``'s entries as ``_launch`` calls them, recorded."""

    def __init__(self):
        self.prepared = 0
        self.launched = []

        def prepare():           # a function: the wrapper sets its restype
            self.prepared += 1
            return 0
        self.rwkv6_scan_prepare = prepare

    def entry(self, name):
        def launch(*args):
            # the plan's chunk and tmajor (arguments 13 and 14)
            self.launched.append((name, args[13], args[14]))
            return 0
        return launch


def _stub_launch(monkeypatch, capturing):
    """``_launch`` on CPU tensors with its CUDA calls stubbed: the operand
    checks, the stream, the library (a :class:`_FakeScanLib`) and the
    capture state (``capturing[0]``); the device setting made afresh."""
    lib = _FakeScanLib()
    monkeypatch.setattr(wkv, "require", lambda t, *a, **k: t)
    monkeypatch.setattr(wkv, "aligned16", lambda *t: True)
    monkeypatch.setattr(wkv, "cuda_stream", lambda t: 0)
    monkeypatch.setattr(wkv, "_fn", lib.entry)
    monkeypatch.setattr(wkv._build, "load", lambda source: lib)
    monkeypatch.setattr(wkv, "_PREPARED", set())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    return lib


def _wkv_operands(b, t, dtype=torch.float32):
    """``rwkv6_scan``'s operands at [b, 32, t, 64] as the model hands them:
    r, k, v, w [B, H, T, D] views of contiguous [B, T, H, D] tensors."""
    rkvw = [torch.zeros((b, t, 32, 64)).movedim(1, 2) for _ in range(4)]
    return ([z.to(dtype) for z in rkvw[:3]] + rkvw[3:]
            + [torch.zeros((32, 64)), None])


def test_rwkv6_shared_memory_setting_precedes_a_capture_of_any_length(
        monkeypatch):
    """An ``LmEngine`` warms a prefill up once a signature but for the
    prompt's length: its first prompt of one token launches the one-step
    kernel outside a capture, and a later fp32 prompt of 128 tokens is
    captured with no warm-up of its own, its chunked kernel past 48 KB of
    shared memory. The first launch made the device setting, so the
    capture never reaches it."""
    capturing = [False]
    lib = _stub_launch(monkeypatch, capturing)
    wkv._launch(*_wkv_operands(2, 1))
    assert lib.prepared == 1 and lib.launched == [("rwkv6_scan_f32", 0, 0)]
    capturing[0] = True
    y, _ = wkv._launch(*_wkv_operands(2, 128))
    assert wkv.rwkv6_scan_plan(2, 32, 128, 64).smem > wkv.DEFAULT_SHARED_BYTES
    assert lib.prepared == 1 and lib.launched[1:] == [
        ("rwkv6_scan_f32", 32, 1)]
    assert y.shape == (2, 32, 128, 64) and y.movedim(1, 2).is_contiguous()


def test_rwkv6_first_launch_inside_a_capture(monkeypatch):
    """A first launch on a device inside a capture makes no device setting:
    one that needs it (fp32 T = 128: past 48 KB) raises before launching,
    one that does not (T = 1; bf16 T = 128) launches; the first launch
    outside a capture then makes it, once."""
    capturing = [True]
    lib = _stub_launch(monkeypatch, capturing)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        wkv._launch(*_wkv_operands(2, 128))
    wkv._launch(*_wkv_operands(2, 1))
    wkv._launch(*_wkv_operands(2, 128, torch.bfloat16))
    assert lib.prepared == 0 and lib.launched == [
        ("rwkv6_scan_f32", 0, 0), ("rwkv6_scan_bf16", 32, 1)]
    capturing[0] = False
    wkv._launch(*_wkv_operands(2, 128))
    wkv._launch(*_wkv_operands(2, 128))
    assert lib.prepared == 1 and lib.launched[2:] == [
        ("rwkv6_scan_f32", 32, 1)] * 2
