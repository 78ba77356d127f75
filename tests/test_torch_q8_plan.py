"""The launch plan of the int8 / int4 kernels (``q8_launch_plan`` in
``repro_torch/kernels/delta_q8.py``), on the CPU.

The plan is arithmetic on a layout's geometry, computed once on the host
and cached, so a launch makes no CUDA API query. It must:

* fit the 227 KB (232,448 B) a block of an sm_90 card may opt in to, for
  every network size of ``PAPER_NETWORKS``, both cells (the GRU and its LSTM
  twin), int8 and int4, plain and buffered, at B = 1..9: the one-stream
  instance at B = 1, the tile instance (up to 8 streams a pass) above;
* pick the narrow-load instance exactly for block rows that are not a
  multiple of 16 bytes;
* give every buffered layout a fill (tensor copies where the row stride
  and the block width in bytes are multiples of 16, else cp.async or 2-byte
  copies through the narrow walk: no layout is refused) and a ring deep
  enough for one unrolled group of the walk, twice over.
"""
import pytest
import torch

from repro_torch.kernels import delta_q8 as q8
from repro_torch.models.gru_rnn import PAPER_NETWORKS

BLOCK_KS = range(4, 260, 4)


def _geometry(i_dim, h_dim, block_k):
    """``(ip, k)`` of a layer packed at ``block_k`` (``_GruBlockGeometry``)."""
    ip = i_dim + (-i_dim) % block_k
    hk = h_dim + (-h_dim) % block_k
    return ip, ip + hk


def _row_bytes(bits, block_k, k):
    """Bytes of one gate row's block and of the whole packed row."""
    return (block_k, k) if bits == 8 else (block_k // 2, k // 2)


@pytest.mark.parametrize("name", sorted(PAPER_NETWORKS))
@pytest.mark.parametrize("gates", [3, 4])
def test_plan_fits_shared_memory_at_every_paper_size(name, gates):
    cfg = PAPER_NETWORKS[name]
    for layer in range(cfg.num_layers):
        i_dim = cfg.input_size if layer == 0 else cfg.hidden_size
        ip, k = _geometry(i_dim, cfg.hidden_size, 128)
        for bits in (8, 4):
            wbk, _ = _row_bytes(bits, 128, k)
            for buffered in (False, True):
                for b in range(1, 10):
                    plan = q8.q8_launch_plan(gates, bits, 128, ip, k,
                                             cfg.hidden_size, b, buffered)
                    assert plan.smem <= q8.SMEM_OPTIN_BYTES == 232_448
                    assert plan.smem == q8.q8_smem_bytes(
                        gates, wbk, k, 128, plan.chunk, plan.stages,
                        q8.Q8_ROWS + int(buffered))
                    assert plan.instance == ("one_stream" if b == 1
                                             else "tile")
                    assert plan.chunk == min(b, q8.Q8_MAX_STREAMS)
                    assert plan.blocks_per_group == (
                        8 * q8.Q8_UNROLL // (wbk // 16))
                    assert plan.grid * q8.Q8_ROWS >= cfg.hidden_size
                    assert plan.threads == 32 * (q8.Q8_ROWS + buffered)
                    assert (plan.stages >= 3) == buffered


@pytest.mark.parametrize("bits", [8, 4])
def test_plan_picks_the_narrow_instance_exactly_for_unaligned_rows(bits):
    for block_k in BLOCK_KS:
        ip, k = _geometry(40, 768, block_k)
        wbk, _ = _row_bytes(bits, block_k, k)
        for b in (1, 2, 9):
            plan = q8.q8_launch_plan(4, bits, block_k, ip, k, 768, b, False)
            assert (plan.instance == "narrow") == (wbk % 16 != 0), block_k
            want = 16 if wbk % 16 == 0 else (4 if bits == 8 else 2)
            assert plan.vector_bytes == want
            assert wbk % plan.vector_bytes == 0
            if plan.instance == "narrow":      # any B, tile accumulators
                assert plan.chunk == min(b, q8.Q8_MAX_STREAMS)


@pytest.mark.parametrize("bits", [8, 4])
def test_plan_refuses_buffered_layouts_exactly_where_r10_says(bits):
    # R10 is repaired: no buffered layout is refused any more. Where the
    # tensor copies cannot run (a row stride or a block width in bytes that
    # is not a multiple of 16) the plan fills the ring with cp.async copies
    # (or 2-byte copies) through the narrow walk, at the same ring depth
    for block_k in BLOCK_KS:
        for i_dim, h_dim in ((40, 768), (768, 768), (14, 256), (8, 128)):
            ip, k = _geometry(i_dim, h_dim, block_k)
            wbk, wk = _row_bytes(bits, block_k, k)
            plan = q8.q8_launch_plan(3, bits, block_k, ip, k, h_dim, 1, True)
            narrow = bool(wk % 16 or wbk % 16)
            assert plan.instance == ("narrow" if narrow else "one_stream")
            assert plan.fill == ("tensor" if not narrow else
                                 "copy" if wbk % 4 else "cp.async")
            # a group of the walk holds at most ceil(32 / L) + 1 blocks
            # (L vectors a block row), and the ring takes two groups
            per_block = wbk // plan.vector_bytes
            span = 8 * q8.Q8_UNROLL
            group = -(-span // per_block) + (span % per_block != 0)
            assert plan.stages == max(3, 2 * group)
            assert plan.smem <= q8.SMEM_OPTIN_BYTES


def test_plan_is_cached_per_geometry_streams_buffering_and_device():
    ip, k = _geometry(768, 768, 128)
    a = q8.q8_launch_plan(4, 8, 128, ip, k, 768, 1, False, 0)
    assert q8.q8_launch_plan(4, 8, 128, ip, k, 768, 1, False, 0) is a
    assert q8.q8_launch_plan(4, 8, 128, ip, k, 768, 1, False, 1).device == 1
    assert q8.q8_launch_plan(4, 8, 128, ip, k, 768, 2, False, 0) != a
    assert q8.q8_launch_plan(4, 8, 128, ip, k, 768, 1, True, 0).stages > 0


def test_plan_needs_no_cuda_api(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plan queried CUDA")

    for name in ("is_available", "current_device", "get_device_properties",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    ip, k = _geometry(40, 500, 64)
    plan = q8.q8_launch_plan.__wrapped__(4, 4, 64, ip, k, 500, 7, True, 0)
    assert plan.instance == "tile" and plan.chunk == 7


def test_plan_shrinks_the_stream_chunk_then_refuses():
    # one stream of k = 16384 stages 80 KB of deltas: two fit 227 KB,
    # three do not
    plan = q8.q8_launch_plan(4, 8, 128, 8192, 16384, 768, 8, False)
    assert plan.chunk == 2 and plan.smem <= q8.SMEM_OPTIN_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        q8.q8_launch_plan(4, 8, 128, 32768, 65536, 768, 1, False)
    with pytest.raises(ValueError, match="multiple of 4"):
        q8.q8_launch_plan(4, 8, 6, 36, 72, 36, 1, False)
