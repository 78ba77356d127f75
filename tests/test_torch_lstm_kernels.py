"""The port's LSTM packs, the plain versions of its LSTM kernels and the
buffered entries of both cells against the JAX package, on the CPU.

* Packs are byte-equal: ``pack_lstm_layer`` and ``pack_delta_weights_q8`` /
  ``_q4`` with ``gates=4`` (codes, scales, bias rows), and
  ``dequantized()`` gives the JAX package's fp32 LSTM layout.
* ``deltalstm_q8_step_ref`` (int8 and int4) is bitwise equal to the JAX
  Pallas kernel run in interpret mode, plain and double-buffered, and to
  the JAX oracle, including a step where nothing fired and one where the
  cell state saturates at the Q8.8 rail: the code-domain sums are exact.
* ``deltagru_q8_step(buffered=True)`` on CPU tensors runs the same plain
  version as the unbuffered call, bitwise equal to JAX's buffered kernel.
* ``deltalstm_seq_step_ref`` (fp32) stays within 1e-5 of both JAX
  versions: the libraries sum up to 288 products per output (k = Ip + Hk
  at these widths) in different orders, and 1e-5 is the JAX package's own
  bound between its batched and per-stream fp32 paths.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""
import functools
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import delta_q8 as jq8
from repro.kernels import deltalstm_seq as jseq
from repro_torch.kernels import delta_q8 as tq8
from repro_torch.kernels import deltalstm_seq as tseq
from repro_torch.kernels import ops

torch.set_num_threads(1)

I_DIM = 40
HIDDEN = [48, 160]     # padding rows and a mid-block x/h seam at both
TOL_F32 = 1e-5


def _weights(h, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    s = (6.0 / (I_DIM + 4 * h)) ** 0.5
    w_x = rng.uniform(-s, s, (4 * h, I_DIM)).astype(np.float32)
    w_h = rng.uniform(-s, s, (4 * h, h)).astype(np.float32)
    b = (rng.normal(0, 0.3, 4 * h) if bias else np.zeros(4 * h)).astype(
        np.float32)
    w_h[5] = 0.0           # one all-zero hidden row: its scale stays 1/qmax
    w_x[5] = 0.0
    return w_x, w_h, b


def _step_inputs(h, b, seed, fire, quant):
    """``(m, h_prev, c_prev, dx, dh)``: each stream fires a random subset of
    its input and hidden elements (``fire`` = fraction); on the Q8.8 grid,
    with ``m`` in the code domain, when ``quant``."""
    rng = np.random.default_rng(seed)
    dx = rng.uniform(-1, 1, (b, I_DIM)) * (rng.uniform(size=(b, I_DIM)) < fire)
    dh = rng.uniform(-1, 1, (b, h)) * (rng.uniform(size=(b, h)) < fire)
    m = rng.normal(0, 1, (b, 4 * h))
    hp = rng.uniform(-1, 1, (b, h))
    cp = rng.uniform(-3, 3, (b, h))
    if quant:
        dx, dh, hp, cp = (np.round(a * 256) / 256 for a in (dx, dh, hp, cp))
        m = np.round(m * 256 * 16) / 256
    return [a.astype(np.float32) for a in (m, hp, cp, dx, dh)]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _q8_layouts(h, bits, block=128, b=None):
    w_x, w_h, bias = _weights(h, seed=2)
    bias = bias if b is None else b
    kw = dict(gates=4, weight_bits=bits, block_h=block, block_k=block)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   jnp.asarray(bias), **kw)
    tl = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h),
                                   torch.from_numpy(bias), **kw)
    return jl, tl


# -- packs --------------------------------------------------------------------

@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("block", [32, 128])
def test_pack_lstm_layer_bytes(h, block):
    w_x, w_h, _ = _weights(h)
    jl = jseq.pack_lstm_layer(jnp.asarray(w_x), jnp.asarray(w_h), block,
                              block)
    tl = tseq.pack_lstm_layer(torch.from_numpy(w_x), torch.from_numpy(w_h),
                              block, block)
    _eq(jl.w, tl.w.numpy())
    for attr in ("ip", "hk", "hp", "nbk", "nbk_x", "nbo"):
        assert getattr(jl, attr) == getattr(tl, attr)
    with pytest.raises(ValueError, match=r"\[4H, I\]"):
        tseq.pack_lstm_layer(torch.from_numpy(w_x[:3 * h]),
                             torch.from_numpy(w_h[:3 * h]))


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_lstm_quant_pack_bytes(h, bits, bias):
    w_x, w_h, b = _weights(h, bias=bias)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   jnp.asarray(b) if bias else None, gates=4,
                                   weight_bits=bits)
    tl = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h),
                                   torch.from_numpy(b) if bias else None,
                                   gates=4, weight_bits=bits)
    assert tl.w_q.dtype == torch.int8 and tl.gates == 4
    _eq(jl.w_q, tl.w_q.numpy())            # int8 codes / packed nibbles
    _eq(jl.scales, tl.scales.numpy())
    _eq(jl.b4, tl.b4.numpy())
    _eq(jq8._layout_codes_f32(jl), tq8._layout_codes_f32(tl).numpy())
    jd, td = jl.dequantized(), tl.dequantized()
    assert isinstance(td, tseq.FusedLstmLayout)
    _eq(jd.w, td.w.numpy())
    # the LSTM spelling of the packer gives the same layout
    if bits == 8:
        sl = tseq.pack_lstm_weights_q8(torch.from_numpy(w_x),
                                       torch.from_numpy(w_h),
                                       torch.from_numpy(b) if bias else None)
        _eq(sl.w_q.numpy(), tl.w_q.numpy())
        assert tseq.QuantLstmLayout is tq8.QuantDeltaLayout


# -- the int8 / int4 LSTM step ------------------------------------------------------

@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("fire", [0.0, 0.3, 1.0])
def test_lstm_q8_step_ref_bitwise_vs_jax_kernels_and_oracle(h, bits, b, fire):
    jl, tl = _q8_layouts(h, bits)
    args = _step_inputs(h, b, 10 * b + int(fire * 10), fire, quant=True)
    targs = list(map(torch.from_numpy, args))
    tm, th, tc = tq8.deltalstm_q8_step_ref(tl, *targs)
    jargs = list(map(jnp.asarray, args))
    for j in (jq8.deltalstm_q8_step(jl, *jargs, interpret=True),
              jq8.deltalstm_q8_step(jl, *jargs, interpret=True,
                                    buffered=True),
              jq8.deltalstm_q8_step_ref(jl, *jargs)):
        for a, t in zip(j, (tm, th, tc)):
            _eq(a, t.numpy())
    if fire == 0.0:       # nothing fired: M unchanged, activation still runs
        _eq(tm.numpy(), args[0])
    # the dispatching wrapper runs the plain version for CPU tensors, with
    # or without buffered=, and launches nothing
    before = ops.launch_counts()
    for buffered in (False, True):
        for a, t in zip(tq8.deltalstm_q8_step(tl, *targs, buffered=buffered),
                        (tm, th, tc)):
            _eq(a.numpy(), t.numpy())
    assert ops.launch_counts() == before


@pytest.mark.parametrize("bits", [8, 4])
def test_lstm_q8_cell_state_saturates_at_the_rail(bits):
    # gates driven to their LUT rails (i = f = g = 1.0) and c_prev near the
    # Q8.8 rail: c = f * c_prev + i * g passes 256 and must clip to act_max,
    # never wrap to the negative rail
    h = 48
    bias = np.concatenate([np.full(3 * h, 8.0), np.zeros(h)]).astype(
        np.float32)
    jl, tl = _q8_layouts(h, bits, b=bias)
    m, hp, _, dx, dh = _step_inputs(h, 2, 3, 0.0, quant=True)
    m[:] = 0.0
    cp = np.full((2, h), 255.5, np.float32)
    cp[1, ::2] = -255.5            # the other rail stays where it is
    args = [m, hp, cp, dx, dh]
    tm, th, tc = tq8.deltalstm_q8_step_ref(tl, *map(torch.from_numpy, args))
    assert float(tc.max()) == tl.act_max
    assert np.count_nonzero(tc.numpy() == tl.act_max) > h
    assert float(tc.min()) >= tl.act_min
    jargs = list(map(jnp.asarray, args))
    for j in (jq8.deltalstm_q8_step(jl, *jargs, interpret=True),
              jq8.deltalstm_q8_step(jl, *jargs, interpret=True,
                                    buffered=True),
              jq8.deltalstm_q8_step_ref(jl, *jargs)):
        for a, t in zip(j, (tm, th, tc)):
            _eq(a, t.numpy())


def test_lstm_q8_needs_a_four_gate_layout():
    _, tl = _q8_layouts(48, 8)
    gru = tq8.pack_delta_weights_q8(torch.zeros(144, 40), torch.zeros(144, 48))
    args = [torch.zeros(1, 192), torch.zeros(1, 48), torch.zeros(1, 48),
            torch.zeros(1, 40), torch.zeros(1, 48)]
    with pytest.raises(ValueError, match="4-gate layout"):
        tq8._launch_q8(gru, 4, False, args[0], args[2], args[3], args[4])
    with pytest.raises(ValueError, match="3-gate layout"):
        tq8._launch_q8(tl, 3, False, args[0], args[1], args[3], args[4])


@pytest.mark.parametrize("bits", [8, 4])
def test_buffered_launch_refuses_unaligned_blocks(bits):
    # an 8-column block (8 or 4 bytes a row) is no longer refused by the
    # plan: its ring is filled by 8-byte cp.async copies. The launch gets as
    # far as the operand checks, which refuse what the kernel cannot take
    # (here CPU tensors), and on CPU tensors the public entry runs the plain
    # version, bitwise equal to the unbuffered call
    _, tl = _q8_layouts(48, bits, block=8)
    args = list(map(torch.from_numpy, _step_inputs(48, 1, 0, 0.3, True)))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tq8._launch_q8(tl, 4, True, args[0], args[2], args[3], args[4])
    k = tl.ip + tl.hk
    plan = tq8.q8_launch_plan(4, bits, 8, tl.ip, k, 48, 1, True)
    assert (plan.instance, plan.fill, plan.copy_bytes) == (
        "narrow", "cp.async", 8 if bits == 8 else 4)
    for x, y in zip(tq8.deltalstm_q8_step(tl, *args, buffered=True),
                    tq8.deltalstm_q8_step(tl, *args)):
        _eq(x.numpy(), y.numpy())


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("bits,block", [(8, 8), (4, 16)])
@pytest.mark.parametrize("fire", [0.0, 0.3])
def test_narrow_buffered_step_bitwise_vs_jax_buffered_kernel(cell, bits,
                                                             block, fire):
    # the layouts R10 used to refuse (block rows of 8 bytes): the port's
    # buffered entry on CPU tensors against JAX's buffered kernel in
    # interpret mode. This guards the plain path; the kernel's cp.async
    # fill runs only on the card (chip_smoke.py holds it bitwise against
    # the unbuffered kernel there)
    gates = 4 if cell == "lstm" else 3
    h = 48
    rng = np.random.default_rng(gates * 100 + bits + block)
    s = (6.0 / (I_DIM + gates * h)) ** 0.5
    w_x = rng.uniform(-s, s, (gates * h, I_DIM)).astype(np.float32)
    w_h = rng.uniform(-s, s, (gates * h, h)).astype(np.float32)
    b = rng.normal(0, 0.3, gates * h).astype(np.float32)
    kw = dict(gates=gates, weight_bits=bits, block_h=block, block_k=block)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   jnp.asarray(b), **kw)
    tl = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h), torch.from_numpy(b),
                                   **kw)
    m, hp, cp, dx, dh = _step_inputs(h, 3, 11, fire, quant=True)
    args = [m, hp, cp, dx, dh] if cell == "lstm" else [m, hp, dx, dh]
    step = {"lstm": (tq8.deltalstm_q8_step, jq8.deltalstm_q8_step),
            "gru": (tq8.deltagru_q8_step, jq8.deltagru_q8_step)}[cell]
    got = step[0](tl, *map(torch.from_numpy, args), buffered=True)
    want = step[1](jl, *map(jnp.asarray, args), interpret=True,
                   buffered=True)
    for a, t in zip(want, got):
        _eq(a, t.numpy())


# -- the fired patterns of the CUDA walk ---------------------------------------
# At I = 600, H = 200 and block_k = 128 a layer has 5 x-blocks and 2 h-blocks
# (the x/h seam between blocks 4 and 5). The CUDA walk issues its loads in
# groups of 4 fired blocks (int8) or 8 (int4, two blocks a warp load), so
# these patterns cover an empty walk, one block, both sides of a group's
# tail, every block, and a group that crosses the seam (the GRU routes the
# candidate row by it); B = 9 takes two passes of the kernels' tile
# instance. "solo" fires every block, each in one stream other than stream
# 0 alone (at B > 1), so only the union over the streams finds it.
# chip_smoke.py runs the same counts on the card at 2L-768H.
WALK_I, WALK_H = 600, 200
WALK_FIRED = {"none": (), "one": (6,), "three": (0, 2, 5),
              "four": (1, 2, 3, 6), "five": (0, 1, 3, 4, 6),
              "all": tuple(range(7)), "seam": (3, 4, 5, 6),
              "solo": tuple(range(7))}


@functools.lru_cache(maxsize=None)
def _walk_layouts(gates, bits):
    rng = np.random.default_rng(gates + bits)
    s = (6.0 / (WALK_I + gates * WALK_H)) ** 0.5
    w_x = rng.uniform(-s, s, (gates * WALK_H, WALK_I)).astype(np.float32)
    w_h = rng.uniform(-s, s, (gates * WALK_H, WALK_H)).astype(np.float32)
    b = rng.normal(0, 0.3, gates * WALK_H).astype(np.float32)
    kw = dict(gates=gates, weight_bits=bits)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   jnp.asarray(b), **kw)
    tl = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h), torch.from_numpy(b),
                                   **kw)
    return jl, tl


def _fired_block_inputs(tl, b, fired, seed, solo=False):
    """``(m, h_prev, c_prev, dx, dh)`` on the Q8.8 grid whose deltas fire
    exactly the column blocks ``fired`` in the union of the streams: each
    block in a random owner stream and, unless ``solo``, in each other
    stream with odds of one half; with ``solo`` (and ``b > 1``) the owner
    is never stream 0 and no other stream fires the block."""
    rng = np.random.default_rng(seed)
    bk, ip = tl.block_k, tl.ip
    d = np.zeros((b, ip + tl.hk))
    for blk in fired:
        owner = int(rng.integers(1 if solo and b > 1 else 0, b))
        for s in range(b):
            if s == owner or (not solo and rng.uniform() < 0.5):
                d[s, blk * bk:(blk + 1) * bk] = rng.uniform(-1, 1, bk)
    d[:, WALK_I:ip] = 0.0
    d[:, ip + WALK_H:] = 0.0
    d = np.round(d * 256) / 256
    union = np.flatnonzero(d.reshape(b, tl.nbk, bk).any(axis=(0, 2)))
    assert tuple(union) == tuple(fired)
    m = np.round(rng.normal(0, 1, (b, 4 * WALK_H)) * 256 * 16) / 256
    hp = np.round(rng.uniform(-1, 1, (b, WALK_H)) * 256) / 256
    cp = np.round(rng.uniform(-3, 3, (b, WALK_H)) * 256) / 256
    return [a.astype(np.float32) for a in
            (m, hp, cp, d[:, :WALK_I], d[:, ip:ip + WALK_H])]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("pattern", sorted(WALK_FIRED))
def test_q8_step_ref_bitwise_vs_jax_on_the_walk_patterns(cell, bits, b,
                                                         pattern):
    gates = 4 if cell == "lstm" else 3
    jl, tl = _walk_layouts(gates, bits)
    fired = WALK_FIRED[pattern]
    m, hp, cp, dx, dh = _fired_block_inputs(tl, b, fired, len(fired) + b,
                                            solo=pattern == "solo")
    args = [m, hp, cp, dx, dh] if cell == "lstm" else [m, hp, dx, dh]
    step = {"lstm": (tq8.deltalstm_q8_step_ref, jq8.deltalstm_q8_step),
            "gru": (tq8.deltagru_q8_step_ref, jq8.deltagru_q8_step)}[cell]
    want = step[0](tl, *map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    for buffered in (False, True):
        for a, t in zip(step[1](jl, *jargs, interpret=True,
                                buffered=buffered), want):
            _eq(a, t.numpy())
    if not fired:          # nothing fired: M unchanged
        _eq(want[0].numpy(), m)


# -- the buffered GRU step ----------------------------------------------------

@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fire", [0.0, 0.3])
def test_gru_buffered_bitwise_vs_jax_buffered_kernel(h, bits, fire):
    rng = np.random.default_rng(h + bits)
    s = (6.0 / (I_DIM + 3 * h)) ** 0.5
    w_x = rng.uniform(-s, s, (3 * h, I_DIM)).astype(np.float32)
    w_h = rng.uniform(-s, s, (3 * h, h)).astype(np.float32)
    b = rng.normal(0, 0.3, 3 * h).astype(np.float32)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   jnp.asarray(b), weight_bits=bits)
    tl = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h), torch.from_numpy(b),
                                   weight_bits=bits)
    m, hp, _, dx, dh = _step_inputs(h, 3, 7, fire, quant=True)
    args = [m, hp, dx, dh]
    targs = list(map(torch.from_numpy, args))
    plain = tq8.deltagru_q8_step(tl, *targs)
    buffered = tq8.deltagru_q8_step(tl, *targs, buffered=True)
    jb = jq8.deltagru_q8_step(jl, *map(jnp.asarray, args), interpret=True,
                              buffered=True)
    for p, q, j in zip(plain, buffered, jb):
        _eq(p.numpy(), q.numpy())
        _eq(j, q.numpy())


# -- the fp32 LSTM step ---------------------------------------------------------------

@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("fire", [0.0, 0.3, 1.0])
def test_lstm_seq_step_ref_within_bound_of_jax_kernel_and_oracle(h, b, fire):
    w_x, w_h, _ = _weights(h, seed=3)
    jl = jseq.pack_lstm_layer(jnp.asarray(w_x), jnp.asarray(w_h))
    tl = tseq.pack_lstm_layer(torch.from_numpy(w_x), torch.from_numpy(w_h))
    args = _step_inputs(h, b, 100 + b, fire, quant=False)
    t = tseq.deltalstm_seq_step_ref(tl, *map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    for j in (jseq.deltalstm_seq_step(jl, *jargs, interpret=True),
              jseq.deltalstm_seq_step_ref(jl, *jargs)):
        for a, x in zip(j, t):
            np.testing.assert_allclose(np.asarray(a), x.numpy(), rtol=0,
                                       atol=TOL_F32)
    if fire == 0.0:
        _eq(t[0].numpy(), args[0])
    before = ops.launch_counts()
    for a, x in zip(tseq.deltalstm_seq_step(tl, *map(torch.from_numpy, args)),
                    t):
        _eq(a.numpy(), x.numpy())
    assert ops.launch_counts() == before


@pytest.mark.parametrize("fire", [0.0, 0.01])
def test_lstm_unfired_blocks_do_not_reach_the_sum(fire):
    # The CUDA kernels read only the column blocks that the JAX package's
    # compaction marks as fired in some stream. Garbage weights in every
    # other block must leave the plain versions' bits unchanged.
    block, h = 32, 160
    w_x, w_h, b = _weights(h)
    jl = jseq.pack_lstm_layer(jnp.asarray(w_x), jnp.asarray(w_h), block,
                              block)
    args = _step_inputs(h, 2, 5, fire, quant=True)
    m, hp, cp, dx, dh = map(jnp.asarray, args)
    _, _, _, n_active, ids = jq8._prep_step_operands(jl, m, hp, dx, dh)
    unfired = np.ones(jl.nbk, bool)
    unfired[np.asarray(ids)[:int(n_active[0])]] = False
    assert unfired.any()
    cols = np.repeat(unfired, block)
    targs = list(map(torch.from_numpy, args))
    fl = tseq.pack_lstm_layer(torch.from_numpy(w_x), torch.from_numpy(w_h),
                              block, block)
    ql = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h), torch.from_numpy(b),
                                   gates=4, block_h=block, block_k=block)
    junk_w = fl.w.clone()
    junk_w[:, :, cols] = 1e3
    junk_c = ql.w_codes_f32.clone()
    junk_c[:, :, cols] = 99.0
    for ref, lay, junk in (
            (tseq.deltalstm_seq_step_ref, fl, replace(fl, w=junk_w)),
            (tq8.deltalstm_q8_step_ref, ql, replace(ql, w_codes_f32=junk_c))):
        for x, y in zip(ref(lay, *targs), ref(junk, *targs)):
            _eq(x.numpy(), y.numpy())


def test_every_kernel_instance_is_listed_once():
    names = [k.name for k in ops.KERNELS]
    assert len(names) == len(set(names)) == 16
    assert names[10:] == ["delta_spmv_f32", "delta_spmv_bf16",
                          "rglru_scan_f32", "rwkv6_scan_f32",
                          "rwkv6_scan_bf16", "deltagru_act_f32"]
    for gates in (3, 4):
        for bits in (8, 4):
            for buffered in (False, True):
                k = ops.q8_kernel(gates, bits, buffered)
                assert k in ops.KERNELS
                assert ("lstm" in k.name) == (gates == 4)
                assert ("dbuf" in k.name) == buffered
                assert k.name.endswith(f"i{bits}")
