"""The launch plans of the fp32 layer steps (``f32_step_plan`` in
``repro_torch/kernels/delta_step_f32.py``) and of ``delta_spmv``
(``spmv_launch_plan`` in ``repro_torch/kernels/delta_spmv.py``), and the
ring fill the int8 / int4 plan picks for the buffered form
(``q8_launch_plan``), on the CPU.

Each plan is arithmetic on a layer's geometry, computed once on the host
and cached, so a launch makes no CUDA API query; the C entries refuse a
plan whose shared memory is not exactly what the kernel lays out. They
must:

* pick the one-stream instance at B = 1 and the tile instance above (up to
  8 streams a pass), and ``delta_spmv``'s narrow instance exactly where a
  row or a block is not a whole number of 16-byte vectors;
* fit the 227 KB (232,448 B) a block of an sm_90 card may opt in to, at
  every network size of ``PAPER_NETWORKS`` and the LM layer shapes, with
  the shared memory exactly the layout's size;
* split the k blocks of a narrow output (the 64-row RWKV6 decay call) over
  the blocks of a cluster, and only there, and give ``delta_spmv``'s
  one-stream instance no more blocks than the SMs hold at once;
* keep their refusals;
* give every buffered int8 / int4 layout a fill: tensor copies for 16-byte
  block rows, else the widest ``cp.async`` of 8 or 4 bytes that divides the
  block row and the row stride, else 2-byte copies.
"""
import pytest
import torch

from repro_torch.kernels import delta_q8 as q8
from repro_torch.kernels import delta_spmv as sp
from repro_torch.kernels import delta_step_f32 as f32
from repro_torch.models.gru_rnn import PAPER_NETWORKS

BLOCK_KS = range(4, 260, 4)
# the four delta_spmv calls of an LM layer step on the main path, [I -> O]
LM_CALLS = {"rwkv6": [(2048, 2048)] * 3 + [(2048, 64)],
            "rglru": [(4096, 4096)] * 4}


def _geometry(i_dim, h_dim, block_k):
    """``(ip, k)`` of a layer packed at ``block_k`` (``_GruBlockGeometry``)."""
    ip = i_dim + (-i_dim) % block_k
    hk = h_dim + (-h_dim) % block_k
    return ip, ip + hk


# -- the fp32 layer step --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PAPER_NETWORKS))
def test_step_plan_fits_and_picks_the_instance_by_streams(name):
    cfg = PAPER_NETWORKS[name]
    for layer in range(cfg.num_layers):
        i_dim = cfg.input_size if layer == 0 else cfg.hidden_size
        ip, k = _geometry(i_dim, cfg.hidden_size, 128)
        for b in range(1, 10):
            plan = f32.f32_step_plan(128, ip, k, cfg.hidden_size, b)
            assert plan.instance == ("one_stream" if b == 1 else "tile")
            assert plan.chunk == min(b, f32.F32_MAX_STREAMS)
            assert plan.smem == f32.f32_smem_bytes(k, 128, plan.chunk)
            assert plan.smem <= q8.SMEM_OPTIN_BYTES == 232_448
            assert plan.grid * f32.F32_ROWS >= cfg.hidden_size
            assert plan.threads == 32 * f32.F32_ROWS * f32.F32_SPLIT
            # a group of the walk: U steps of the 8 lanes of a gate, 32
            # float4 vectors a 128-column block row
            assert plan.blocks_per_group == 8 * f32.F32_UNROLL // 32


def test_step_plan_smem_is_the_layout_of_the_kernel():
    # [chunk][kpad(k)] staged floats, a vote word per 32 slots, 18 warps'
    # fired-block lists (6 rows of 3 warps) and the 2 other warps' hand-over
    # of 64 floats a row: 2L-768H layer 1 (k = 1536) at one and 8 streams
    assert (f32.F32_ROWS, f32.F32_SPLIT, f32.F32_UNROLL) == (6, 3, 8)
    for b in (1, 8):
        plan = f32.f32_step_plan(128, 768, 1536, 768, b)
        assert plan.smem == (4 * b * 1920 + 4 * 12 * b + 4 * 18 * 12
                             + 4 * 2 * 6 * 64)
        # 128 blocks of 18 warps; a group covers 2 fired 128-column blocks
        assert (plan.grid, plan.threads, plan.blocks_per_group) == (
            128, 576, 2)


def test_step_plan_refusals_and_the_stream_chunk():
    # one stream of k = 16384 stages 80 KB of deltas: two fit 227 KB
    plan = f32.f32_step_plan(128, 8192, 16384, 768, 8)
    assert plan.chunk == 2 and plan.smem <= q8.SMEM_OPTIN_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        f32.f32_step_plan(128, 32768, 65536, 768, 1)
    for block_k, ip, k in ((6, 36, 72), (128, 100, 228), (128, 128, 200),
                           (0, 0, 128)):
        with pytest.raises(ValueError, match="multiple of 4"):
            f32.f32_step_plan(block_k, ip, k, 64, 1)


def test_step_plan_is_cached_and_needs_no_cuda_api(monkeypatch):
    ip, k = _geometry(40, 768, 128)
    a = f32.f32_step_plan(128, ip, k, 768, 1, 0)
    assert f32.f32_step_plan(128, ip, k, 768, 1, 0) is a
    assert f32.f32_step_plan(128, ip, k, 768, 1, 1).device == 1
    assert f32.f32_step_plan(128, ip, k, 768, 2, 0) != a

    def refuse(*args, **kwargs):
        raise AssertionError("the plan queried CUDA")

    for name in ("is_available", "current_device", "get_device_properties",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    plan = f32.f32_step_plan.__wrapped__(64, 64, 576, 500, 7, 0)
    assert plan.instance == "tile" and plan.chunk == 7


# -- delta_spmv -------------------------------------------------------------------

def _check_grid(plan, o_dim):
    """Every row has a warp. The one-stream instance unsplit runs no more
    blocks than the SMs hold at once (``SPMV_BLOCKS_PER_SM`` an SM): one
    block a row group while they fit, else that many blocks with two rows
    a warp (or more blocks where even that does not cover the output); the
    others run a block a row group (times the split)."""
    groups = -(-o_dim // sp.SPMV_ROWS)
    resident = sp.H100_SMS * sp.SPMV_BLOCKS_PER_SM
    assert plan.grid % plan.split == 0
    assert plan.grid // plan.split * sp.SPMV_ROWS * plan.rows >= o_dim
    if (plan.instance == "one_stream" and plan.split == 1
            and groups > resident):
        assert plan.rows == sp.SPMV_MAX_ROWS == 2
        assert plan.grid == max(resident, -(-o_dim // (2 * sp.SPMV_ROWS)))
    else:
        assert (plan.rows, plan.grid) == (1, groups * plan.split)


@pytest.mark.parametrize("cell", sorted(LM_CALLS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_plan_at_the_lm_calls(cell, dtype):
    for i_dim, o_dim in LM_CALLS[cell]:
        for b in range(1, 10):
            plan = sp.spmv_launch_plan(o_dim, i_dim, i_dim, 128, b, dtype)
            assert plan.instance == ("one_stream" if b == 1 else "tile")
            assert plan.vector_elems == 16 // dtype.itemsize
            assert plan.chunk == min(b, sp.SPMV_MAX_STREAMS)
            assert plan.smem == sp.spmv_smem_bytes(i_dim, 128, plan.chunk,
                                                   plan.split)
            assert plan.smem <= q8.SMEM_OPTIN_BYTES
            _check_grid(plan, o_dim)
            # only the narrow decay output (8 row groups) splits its 16
            # k blocks, over 8 blocks of a cluster: 64 blocks, not 8
            assert plan.split == (8 if o_dim == 64 else 1)
            # a group of the walk: SPMV_UNROLL steps of 32 vectors over
            # the rows a warp walks at once
            assert plan.blocks_per_group == max(1, 32 * sp.SPMV_UNROLL * (
                16 // dtype.itemsize) // (128 * plan.rows))


def test_spmv_plan_split_follows_the_row_groups():
    for o_dim in range(1, 2200, 37):
        for i_dim in (100, 512, 2048):
            plan = sp.spmv_launch_plan(o_dim, i_dim, i_dim, 128, 1)
            groups = -(-o_dim // sp.SPMV_ROWS)
            nbk = -(-i_dim // 128)
            assert 1 <= plan.split <= min(sp.SPMV_MAX_SPLIT, nbk)
            if groups * 2 > sp.H100_SMS or nbk == 1:
                assert plan.split == 1
            else:   # as many cluster blocks as fit the SMs, up to 8
                assert plan.split == min(sp.SPMV_MAX_SPLIT, nbk,
                                         sp.H100_SMS // groups)
            _check_grid(plan, o_dim)
            assert plan.grid <= max(groups, sp.H100_SMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_plan_picks_narrow_exactly_for_partial_vectors(dtype):
    vec = 16 // dtype.itemsize
    for block_k in BLOCK_KS:
        for i_dim, ldw in ((999, 999), (1000, 1000), (1002, 1002),
                           (1000, 1024), (64, 64)):
            if ldw != i_dim:      # packed: the row stride is I padded
                ldw = -(-i_dim // block_k) * block_k
            for b in (1, 3):
                plan = sp.spmv_launch_plan(130, i_dim, ldw, block_k, b,
                                           dtype)
                _check_grid(plan, 130)
                wide = ldw % vec == 0 and block_k % vec == 0
                assert (plan.instance == "narrow") == (not wide)
                assert plan.vector_elems == (vec if wide else 1)
                if not wide:      # any B, tile accumulators
                    assert plan.chunk == b


def test_spmv_plan_refusals_cache_and_no_cuda_api(monkeypatch):
    for bad in (dict(block_k=6), dict(block_k=0), dict(ldw=90)):
        kw = dict(o_dim=64, i_dim=100, ldw=100, block_k=128, b=1)
        kw.update(bad)
        with pytest.raises(ValueError, match="block_k"):
            sp.spmv_launch_plan(**kw)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        sp.spmv_launch_plan(64, 128, 128, 128, 1, torch.float16)
    with pytest.raises(ValueError, match="shared memory"):
        sp.spmv_launch_plan(64, 65536, 65536, 128, 1)
    # the stream chunk shrinks to what fits: 8 streams of I = 8192 do not
    plan = sp.spmv_launch_plan(64, 8192, 8192, 128, 8)
    assert plan.chunk == 5 and plan.smem <= q8.SMEM_OPTIN_BYTES
    a = sp.spmv_launch_plan(2048, 2048, 2048, 128, 1, torch.float32, 0)
    assert sp.spmv_launch_plan(2048, 2048, 2048, 128, 1, torch.float32,
                               0) is a
    assert sp.spmv_launch_plan(2048, 2048, 2048, 128, 1, torch.bfloat16,
                               0) != a

    def refuse(*args, **kwargs):
        raise AssertionError("the plan queried CUDA")

    for name in ("is_available", "current_device", "get_device_properties",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    plan = sp.spmv_launch_plan.__wrapped__(64, 2048, 2048, 128, 1,
                                           torch.float32, 0)
    assert plan.split == 8 and plan.grid == 64


# -- the ring fill of the buffered int8 / int4 form ------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gates", [3, 4])
def test_q8_plan_fill_of_every_buffered_layout(bits, gates):
    for block_k in BLOCK_KS:
        ip, k = _geometry(40, 768, block_k)
        wbk = block_k if bits == 8 else block_k // 2
        wk = k if bits == 8 else k // 2
        for b in (1, 9):
            plan = q8.q8_launch_plan(gates, bits, block_k, ip, k, 768, b,
                                     True)
            want = next((c for c in (16, 8, 4)
                         if wbk % c == 0 and wk % c == 0), 2)
            assert plan.copy_bytes == want
            assert plan.fill == {16: "tensor", 2: "copy"}.get(want,
                                                              "cp.async")
            assert (plan.fill == "tensor") == (plan.instance != "narrow")
            unbuffered = q8.q8_launch_plan(gates, bits, block_k, ip, k, 768,
                                           b, False)
            assert (unbuffered.fill, unbuffered.copy_bytes) == ("none", 0)
            assert plan.instance == unbuffered.instance
            assert plan.smem <= q8.SMEM_OPTIN_BYTES
