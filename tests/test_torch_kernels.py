"""The port's packs and the plain versions of its two kernels against the
JAX package, on the CPU.

* Packs are byte-equal: ``pack_cat_volume``, ``pack_gru_layer``,
  ``pack_delta_weights_q8`` / ``_q4`` (codes, scales, bias rows) and the
  nibble layout.
* ``deltagru_q8_step_ref`` (int8 and int4) is bitwise equal to the JAX
  Pallas kernel run in interpret mode and to the JAX oracle, including a
  step where nothing fired: its code-domain sums are exact, so no order of
  summation can change a bit.
* ``deltagru_seq_step_ref`` (fp32) stays within 1e-5 of both: the
  libraries sum the up to 288 products per output (k = Ip + Hk at these
  widths) in different orders, and 1e-5 is the JAX package's own bound
  between its batched and per-stream fp32 paths.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import delta_q8 as jq8
from repro.kernels import deltagru_seq as jseq
from repro_torch.kernels import delta_q8 as tq8
from repro_torch.kernels import deltagru_seq as tseq
from repro_torch.kernels import ops

torch.set_num_threads(1)

I_DIM = 40
HIDDEN = [48, 160]     # padding rows and a mid-block x/h seam at both


def _weights(h, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    s = (6.0 / (I_DIM + 3 * h)) ** 0.5
    w_x = rng.uniform(-s, s, (3 * h, I_DIM)).astype(np.float32)
    w_h = rng.uniform(-s, s, (3 * h, h)).astype(np.float32)
    b = (rng.normal(0, 0.3, 3 * h) if bias else np.zeros(3 * h)).astype(
        np.float32)
    w_h[5] = 0.0           # one all-zero hidden row: its scale stays 1/qmax
    w_x[5] = 0.0
    return w_x, w_h, b


def _step_inputs(h, b, seed, fire, quant):
    """Step operands: each stream fires a random subset of its input and
    hidden elements (``fire`` = fraction), deltas on the Q8.8 grid and
    ``m`` in the code domain when ``quant``."""
    rng = np.random.default_rng(seed)
    dx = rng.uniform(-1, 1, (b, I_DIM)) * (rng.uniform(size=(b, I_DIM)) < fire)
    dh = rng.uniform(-1, 1, (b, h)) * (rng.uniform(size=(b, h)) < fire)
    m = rng.normal(0, 1, (b, 4 * h))
    hp = rng.uniform(-1, 1, (b, h))
    if quant:
        dx, dh, hp = (np.round(a * 256) / 256 for a in (dx, dh, hp))
        m = np.round(m * 256 * 16) / 256
    return [a.astype(np.float32) for a in (m, hp, dx, dh)]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- packs --------------------------------------------------------------------

@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("block", [32, 128])
def test_pack_gru_layer_bytes(h, block):
    w_x, w_h, _ = _weights(h)
    jl = jseq.pack_gru_layer(jnp.asarray(w_x), jnp.asarray(w_h), block, block)
    tl = tseq.pack_gru_layer(torch.from_numpy(w_x), torch.from_numpy(w_h),
                             block, block)
    _eq(jl.w, tl.w.numpy())
    for attr in ("ip", "hk", "hp", "nbk", "nbk_x", "nbo"):
        assert getattr(jl, attr) == getattr(tl, attr)


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_quant_pack_bytes(h, bits, bias):
    w_x, w_h, b = _weights(h, bias=bias)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   jnp.asarray(b) if bias else None,
                                   weight_bits=bits)
    tl = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h),
                                   torch.from_numpy(b) if bias else None,
                                   weight_bits=bits)
    assert tl.w_q.dtype == torch.int8
    _eq(jl.w_q, tl.w_q.numpy())            # int8 codes / packed nibbles
    _eq(jl.scales, tl.scales.numpy())
    _eq(jl.b4, tl.b4.numpy())
    _eq(jq8._layout_codes_f32(jl), tq8._layout_codes_f32(tl).numpy())
    for attr in ("act_scale", "act_min", "act_max", "lut_scale", "lut_min",
                 "lut_max", "weight_bits", "gates", "ip", "hk", "hp"):
        assert getattr(jl, attr) == getattr(tl, attr), attr
    _eq(jl.dequantized().w, tl.dequantized().w.numpy())
    x = np.linspace(-300, 300, 1001).astype(np.float32)
    _eq(jl.quantize_act(jnp.asarray(x)),
        tl.quantize_act(torch.from_numpy(x)).numpy())


def test_nibble_layout_and_round_trip():
    rng = np.random.default_rng(1)
    codes = rng.integers(-8, 8, (3, 16, 256)).astype(np.int8)
    jp = jq8.pack_nibbles(jnp.asarray(codes), 128)
    tp = tq8.pack_nibbles(torch.from_numpy(codes), 128)
    _eq(jp, tp.numpy())
    assert (tp.numpy() < 0).any()            # bytes above 127 wrap to int8
    _eq(tq8.unpack_nibbles(tp, 128).numpy(), codes)
    # byte j of a block: column j low nibble, column j + 64 high nibble
    p = tp.numpy().astype(np.int32)
    assert ((((p[0, 0, 3] & 15) ^ 8) - 8) == codes[0, 0, 3])
    assert (((((p[0, 0, 3] >> 4) & 15) ^ 8) - 8) == codes[0, 0, 3 + 64])
    with pytest.raises(ValueError, match="not a multiple"):
        tq8.pack_nibbles(torch.zeros(3, 100, dtype=torch.int8), 128)


def test_pack_validation():
    w_x, w_h, b = _weights(48)
    with pytest.raises(ValueError, match="weight_bits must be 4 or 8"):
        tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                  torch.from_numpy(w_h), weight_bits=2)
    with pytest.raises(ValueError, match="wrong cell family"):
        tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                  torch.from_numpy(w_h), gates=4)


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("fire", [0.0, 0.05, 1.0])
def test_unfired_blocks_do_not_reach_the_sum(h, fire):
    # The CUDA kernels read only the column blocks that the JAX package's
    # compaction (_prep_step_operands) marks as fired in some stream of the
    # tile. Garbage weights in every other block must leave the plain
    # versions' bits unchanged: those columns multiply exact zeros.
    block = 32
    w_x, w_h, b = _weights(h)
    jl = jseq.pack_gru_layer(jnp.asarray(w_x), jnp.asarray(w_h), block, block)
    args = _step_inputs(h, 2, 5, fire, quant=True)
    _, _, _, n_active, ids = jq8._prep_step_operands(
        jl, *map(jnp.asarray, args))
    unfired = np.ones(jl.nbk, bool)
    unfired[np.asarray(ids)[:int(n_active[0])]] = False
    cols = np.repeat(unfired, block)
    targs = list(map(torch.from_numpy, args))
    fl = tseq.pack_gru_layer(torch.from_numpy(w_x), torch.from_numpy(w_h),
                             block, block)
    ql = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h), torch.from_numpy(b),
                                   block_h=block, block_k=block)
    junk_w = fl.w.clone()
    junk_w[:, :, cols] = 1e3
    junk_c = ql.w_codes_f32.clone()
    junk_c[:, :, cols] = 99.0
    for ref, lay, junk in (
            (tseq.deltagru_seq_step_ref, fl, replace(fl, w=junk_w)),
            (tq8.deltagru_q8_step_ref, ql, replace(ql, w_codes_f32=junk_c))):
        for x, y in zip(ref(lay, *targs), ref(junk, *targs)):
            _eq(x.numpy(), y.numpy())


# -- the int8 / int4 step -------------------------------------------------------

def _q8_layouts(h, bits):
    w_x, w_h, b = _weights(h, seed=2)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   jnp.asarray(b), weight_bits=bits)
    tl = tq8.pack_delta_weights_q8(torch.from_numpy(w_x),
                                   torch.from_numpy(w_h), torch.from_numpy(b),
                                   weight_bits=bits)
    return jl, tl


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("fire", [0.0, 0.1, 1.0])
def test_q8_step_ref_bitwise_vs_jax_kernel_and_oracle(h, bits, b, fire):
    jl, tl = _q8_layouts(h, bits)
    args = _step_inputs(h, b, 10 * b + int(fire * 10), fire, quant=True)
    tm, th = tq8.deltagru_q8_step_ref(tl, *map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    km, kh = jq8.deltagru_q8_step(jl, *jargs, interpret=True)
    rm, rh = jq8.deltagru_q8_step_ref(jl, *jargs)
    _eq(km, tm.numpy())
    _eq(kh, th.numpy())
    _eq(rm, tm.numpy())
    _eq(rh, th.numpy())
    if fire == 0.0:       # nothing fired: M unchanged, activation still runs
        _eq(tm.numpy(), args[0])
    # the dispatching wrapper runs the plain version for CPU tensors
    before = ops.launch_counts()
    wm, wh = tq8.deltagru_q8_step(tl, *map(torch.from_numpy, args))
    _eq(wm.numpy(), tm.numpy())
    _eq(wh.numpy(), th.numpy())
    assert ops.launch_counts() == before


def test_q8_plain_version_without_the_code_copy():
    # a layout packed for the card may carry no fp32 code copy: the plain
    # version then unpacks the packed codes itself, to the same bits
    w_x, w_h, b = map(torch.from_numpy, _weights(48, seed=2))
    args = list(map(torch.from_numpy, _step_inputs(48, 2, 7, 0.3, True)))
    for bits in (8, 4):
        full = tq8.pack_delta_weights_q8(w_x, w_h, b, weight_bits=bits)
        bare = tq8.pack_delta_weights_q8(w_x, w_h, b, weight_bits=bits,
                                         with_ref_codes=False)
        assert full.w_codes_f32 is not None and bare.w_codes_f32 is None
        for x, y in zip(tq8.deltagru_q8_step_ref(bare, *args),
                        tq8.deltagru_q8_step_ref(full, *args)):
            _eq(x.numpy(), y.numpy())


def test_lut_activation_grid_matches_jax():
    _, tl = _q8_layouts(48, 8)
    sig, tnh = tq8.lut_activation_grid(tl, "cpu")
    assert sig.numel() == 2 ** 17                 # every Q8.8 input
    x = jnp.arange(-2 ** 16, 2 ** 16, dtype=jnp.float32) / 256.0
    _eq(jq8._grid_round(jax.nn.sigmoid(x), 16.0, -2.0, 2.0 - 1 / 16),
        sig.numpy())
    _eq(jq8._grid_round(jnp.tanh(x), 16.0, -2.0, 2.0 - 1 / 16), tnh.numpy())


# -- the fp32 step ----------------------------------------------------------------

TOL_F32 = 1e-5


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("fire", [0.0, 0.1, 1.0])
def test_seq_step_ref_within_bound_of_jax_kernel_and_oracle(h, b, fire):
    w_x, w_h, _ = _weights(h, seed=3)
    jl = jseq.pack_gru_layer(jnp.asarray(w_x), jnp.asarray(w_h))
    tl = tseq.pack_gru_layer(torch.from_numpy(w_x), torch.from_numpy(w_h))
    args = _step_inputs(h, b, 100 + b, fire, quant=False)
    tm, th = tseq.deltagru_seq_step_ref(tl, *map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    km, kh = jseq.deltagru_seq_step(jl, *jargs, interpret=True)
    rm, rh = jseq.deltagru_seq_step_ref(jl, *jargs)
    for j, t in ((km, tm), (kh, th), (rm, tm), (rh, th)):
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0,
                                   atol=TOL_F32)
    if fire == 0.0:
        _eq(tm.numpy(), args[0])
    wm, _ = tseq.deltagru_seq_step(tl, *map(torch.from_numpy, args))
    _eq(wm.numpy(), tm.numpy())
