"""The launch plans of the two scans (``rwkv6_scan_plan`` in
``repro_torch/kernels/rwkv6_scan.py``, ``rglru_scan_plan`` in
``repro_torch/kernels/rglru_scan.py``), on the CPU.

Each plan is arithmetic on the call's shape, computed once on the host and
cached, so a launch makes no CUDA API query; the C entries refuse a plan
they cannot run. Walked the way the kernels walk them (a block takes units
``blockIdx, blockIdx + grid, ...``; a thread of ``rwkv6_scan`` owns one key
and 4 value columns of its unit, a thread of ``rglru_scan`` 4 channels of
one stream), the plans must:

* cover every ``(b, h, key, column)`` of the WKV state and every ``(b, c)``
  of the RG-LRU state exactly once;
* launch no more blocks than the SMs of an H100 hold at once;
* take the 16-byte path exactly where it is legal: for ``rglru_scan`` when
  ``W % 4 == 0`` and every operand is 16-byte aligned;
* refuse a head size other than 64, negative sizes, and operands that
  are not fp32 (``rwkv6_scan`` also takes bf16 ``r, k, v``);
* be cached, and make no CUDA API call.
"""
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
    assert wkv.RWKV6_THREADS_PER_SM == 2048
    one = wkv.rwkv6_scan_plan(1, 32, 1, 64)
    assert (one.cols, one.threads, one.grid, one.vec) == (16, 256, 128, 4)
    tile = wkv.rwkv6_scan_plan(8, 32, 1, 64)
    assert (tile.grid, tile.units) == (1024, 1024)
    for b in range(1, 20):
        for h in (1, 3, 32):
            plan = wkv.rwkv6_scan_plan(b, h, 128, 64)
            resident = ops.H100_SMS * (2048 // plan.threads)
            assert plan.grid == min(plan.units, resident)
            assert plan.grid <= wkv.rwkv6_resident_blocks(plan.threads)
    # a grid of fewer blocks than units walks them all
    other = wkv.Rwkv6ScanPlan(16, 256, 9 * 3 * 4, 7, 4, -1)
    assert (_wkv_cover(other, 9, 3) == 1).all()


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
        plan = wkv.rwkv6_scan_plan(1, 32, 1, 64, torch.float32, aligned)
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
    """Row 9b: bf16 r, k, v have a plan, the same walk as fp32's; every
    other type is refused."""
    if dtype in (torch.float32, torch.bfloat16):
        plan = wkv.rwkv6_scan_plan(4, 32, 128, 64, dtype)
        assert plan == wkv.rwkv6_scan_plan(4, 32, 128, 64, torch.float32)
        assert (_wkv_cover(plan, 4, 32) == 1).all()
    else:
        with pytest.raises(ValueError, match="fp32 or bf16"):
            wkv.rwkv6_scan_plan(4, 32, 128, 64, dtype)


def test_plans_are_cached_and_need_no_cuda_api(monkeypatch):
    a = wkv.rwkv6_scan_plan(1, 32, 1, 64, torch.float32, True, 0)
    assert wkv.rwkv6_scan_plan(1, 32, 1, 64, torch.float32, True, 0) is a
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
    plan = lru.rglru_scan_plan.__wrapped__(8, 1, 4097, torch.float32, True,
                                           0)
    assert plan.vec == 1 and plan.grid == 65
