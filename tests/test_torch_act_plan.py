"""The launch plan of ``deltagru_act`` (``deltagru_act_plan`` in
``repro_torch/kernels/deltagru_cell.py``), on the CPU.

The plan is arithmetic on the call's shape, computed once on the host and
cached, so a launch makes no CUDA API query. Walked the way the kernel
walks it (a thread of ``csrc/deltagru_cell.cu`` owns one channel ``(b,
o)`` and takes channels ``global thread, + grid * threads, ...``; the last
block masks the channels past ``B * H``), the plan must:

* cover every ``(b, h)`` exactly once, the grid's ragged last block
  included;
* launch no more blocks than the SMs of an H100 hold at once;
* take one path for every width and every 4-byte aligned operand: the
  kernel has no 16-byte path (four channels a thread with 16-byte loads
  was slower on the card), so neither ``H % 4`` nor a pointer's
  alignment past 4 bytes changes the plan;
* be accepted by the C entry (its checks are mirrored here by
  ``c_entry_accepts``), which refuses what it cannot run;
* refuse negative sizes, operands that are not fp32 and operands too large
  for the entry's int offsets;
* be cached, and make no CUDA API call.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import deltagru_cell as act
from repro_torch.kernels import ops


def c_entry_accepts(b, h, threads, grid, ptrs) -> bool:
    """The checks of ``deltagru_act_f32`` in ``csrc/deltagru_cell.cu``
    (``ptrs``: the six pointers as integers); True where it launches, or,
    for a zero-sized call, returns 0 without a launch."""
    if b < 0 or h < 0:
        return False
    if b == 0 or h == 0:
        return True
    if threads not in (32, 64, 128, 256):
        return False
    units = b * h
    if 4 * units > 2 ** 31 - 1 or grid < 1 or grid > -(-units // threads):
        return False
    return all(p != 0 and p % 4 == 0 for p in ptrs)


def _cover(plan, b, h):
    """How often the kernel's threads touch each ``(b, h)`` under
    ``plan``."""
    seen = np.zeros(b * h, np.int64)
    stride = plan.grid * plan.threads
    for thread in range(stride):
        for idx in range(thread, plan.units, stride):
            seen[idx] += 1
    return seen.reshape(b, h)


@pytest.mark.parametrize("b", [1, 2, 8, 9])
@pytest.mark.parametrize("h", [768, 770, 4097, 5, 1])
def test_plan_covers_every_channel_once(b, h):
    plan = act.deltagru_act_plan(b, h)
    assert plan.threads in act.ACT_THREADS
    assert plan.units == b * h
    assert (_cover(plan, b, h) == 1).all()


def test_the_grids_ragged_last_block_is_masked():
    # H = 770 at B = 1: 7 blocks of 128, the last one holding channels 768
    # and 769 only; the 126 threads past them touch nothing
    plan = act.deltagru_act_plan(1, 770)
    assert plan.grid == 7 and plan.grid * plan.threads - plan.units == 126
    seen = _cover(plan, 1, 770)
    assert (seen[:, 768:] == 1).all() and seen.sum() == 770


def test_the_grid_at_the_main_shapes_and_its_residency():
    # 128 threads a block: 6 blocks at B = 1, H = 768, 48 for the 8-slot
    # batcher; at most 16 blocks an SM (its 2048 threads)
    assert act.ACT_PLAN_THREADS == 128
    grids = {b: act.deltagru_act_plan(b, 768).grid for b in (1, 2, 8, 9)}
    assert grids == {1: 6, 2: 12, 8: 48, 9: 54}
    for b in (1, 2, 8, 9, 300, 5000):
        for h in (1, 5, 768, 770, 4097):
            plan = act.deltagru_act_plan(b, h)
            blocks = -(-plan.units // plan.threads)
            resident = ops.H100_SMS * min(32, 2048 // plan.threads)
            assert plan.grid == min(blocks, resident)
            assert plan.grid <= act.act_resident_blocks(plan.threads)
    plan = act.deltagru_act_plan(5000, 4097)      # more units than threads
    assert plan.grid * plan.threads < plan.units
    assert (_cover(act.deltagru_act_plan(700, 9), 700, 9) == 1).all()


def test_one_path_for_every_width():
    # neither H % 4 nor the operands' alignment past 4 bytes moves the plan
    for h in range(1, 40):
        plan = act.deltagru_act_plan(2, h)
        assert (plan.threads, plan.units) == (act.ACT_PLAN_THREADS, 2 * h)
        assert plan.grid == -(-2 * h // plan.threads)


@pytest.mark.parametrize("b,h", [(1, 768), (2, 770), (8, 768), (9, 4097),
                                 (1, 5), (3, 1)])
def test_every_plan_is_one_the_c_entry_runs(b, h):
    plan = act.deltagru_act_plan(b, h)
    aligned = [16 * (k + 1) for k in range(6)]
    for k in range(6):
        # each operand in turn a view one float into its buffer
        offset = list(aligned)
        offset[k] += 4
        for ptrs in (aligned, offset):
            assert c_entry_accepts(b, h, plan.threads, plan.grid, ptrs)


def test_the_c_entrys_refusals():
    ptrs = [16 * (k + 1) for k in range(6)]
    plan = act.deltagru_act_plan(1, 768)
    assert c_entry_accepts(1, 768, plan.threads, plan.grid, ptrs)
    for k in range(6):
        moved = list(ptrs)
        moved[k] += 2                       # 2-byte aligned: refused
        assert not c_entry_accepts(1, 768, 128, 6, moved)
        moved[k] = 0                        # a null pointer
        assert not c_entry_accepts(1, 768, 128, 6, moved)
    for threads in (16, 96, 512, 1024):
        assert not c_entry_accepts(1, 768, threads, 1, ptrs)
    assert not c_entry_accepts(1, 768, 128, 0, ptrs)
    assert not c_entry_accepts(1, 768, 128, 7, ptrs)     # 6 blocks' worth
    assert not c_entry_accepts(-1, 768, 128, 6, ptrs)
    assert not c_entry_accepts(2 ** 20, 2 ** 10, 128, 1, ptrs)
    assert c_entry_accepts(0, 768, 128, 0, ptrs)         # nothing to launch


def test_plan_refusals():
    for bad in ((-1, 768), (1, -4)):
        with pytest.raises(ValueError, match=">= 0"):
            act.deltagru_act_plan(*bad)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        with pytest.raises(ValueError, match="fp32"):
            act.deltagru_act_plan(1, 768, dtype)
    with pytest.raises(ValueError, match="at most"):
        act.deltagru_act_plan(2 ** 20, 2 ** 10)
    assert act.deltagru_act_plan(0, 768).units == 0


def test_the_wrapper_takes_4_byte_aligned_views_on_the_cpu():
    # a contiguous view one float into its buffer is 4- but not 16-byte
    # aligned; the plain version runs on it as on the aligned operands
    rng = np.random.default_rng(3)
    b, h = 2, 130
    ins = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((b, 4 * h), (b, 3 * h), (b, 3 * h), (b, h))]
    want = act.deltagru_act(*ins)
    for k in range(4):
        buf = torch.zeros(ins[k].numel() + 4)
        view = buf[1:1 + ins[k].numel()].view(ins[k].shape)
        view.copy_(ins[k])
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        moved = list(ins)
        moved[k] = view
        for a, w in zip(act.deltagru_act(*moved), want):
            assert torch.equal(a, w)


def test_plan_is_cached_and_needs_no_cuda_api(monkeypatch):
    a = act.deltagru_act_plan(1, 768, torch.float32, 0)
    assert act.deltagru_act_plan(1, 768, torch.float32, 0) is a
    assert act.deltagru_act_plan(1, 768, torch.float32, 1) != a

    def refuse(*args, **kwargs):
        raise AssertionError("the plan queried CUDA")

    for name in ("is_available", "current_device", "get_device_properties",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    plan = act.deltagru_act_plan.__wrapped__(8, 770, torch.float32, 0)
    assert plan.grid == 49 and plan.device == 0
