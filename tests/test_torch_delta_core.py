"""Parity of the port's Delta Unit, thresholds, sparsity, Eq. 5-8 model,
backend registry and fixed-point grids with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Everything here is bitwise (or exact equality of Python numbers), except
``dynamic_threshold``: ``ratio ** gain`` is a transcendental, held to 1 ulp.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jbackends
from repro.core import delta as jdelta
from repro.core import perf_model as jperf
from repro.core import sparsity as jsparsity
from repro.core import thresholds as jthr
from repro_torch.core import backends as tbackends
from repro_torch.core import delta as tdelta
from repro_torch.core import perf_model as tperf
from repro_torch.core import sparsity as tsparsity
from repro_torch.core import thresholds as tthr
from repro_torch.quant import lut as tlut
# the package re-exports the function fake_quant under the module's name
# (as repro.quant does), so the module is imported by its full name
tfq = importlib.import_module("repro_torch.quant.fake_quant")

# repro.quant re-exports a function named fake_quant over its submodule
jfq = importlib.import_module("repro.quant.fake_quant")
jlut = importlib.import_module("repro.quant.lut")

torch.set_num_threads(1)

THETAS = [0.0, 0.05, 0.25, 1.0]


def _stream(seed, shape=(16, 3, 40)):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 0.2, shape), axis=0).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- Delta Unit -------------------------------------------------------------

@pytest.mark.parametrize("theta", THETAS)
def test_delta_encode_bitwise(theta):
    xs = _stream(1)
    js = jdelta.init_delta_state(xs.shape[1:])
    ts = tdelta.init_delta_state(xs.shape[1:])
    for x in xs:
        jo = jdelta.delta_encode(jnp.asarray(x), js, theta)
        to = tdelta.delta_encode(torch.from_numpy(x), ts, theta)
        _eq(jo.delta, to.delta.numpy())
        _eq(jo.fired, to.fired.numpy())
        _eq(jo.state.memory, to.state.memory.numpy())
        js, ts = jo.state, to.state


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("time_axis", [0, 1])
def test_delta_encode_sequence_bitwise(theta, time_axis):
    xs = np.moveaxis(_stream(2), 0, time_axis)
    jd, jf, js = jdelta.delta_encode_sequence(jnp.asarray(xs), theta,
                                              time_axis=time_axis)
    td, tf, ts = tdelta.delta_encode_sequence(torch.from_numpy(xs), theta,
                                              time_axis=time_axis)
    _eq(jd, td.numpy())
    _eq(jf, tf.numpy())
    _eq(js.memory, ts.memory.numpy())


@pytest.mark.parametrize("theta", [0.0, 0.25])
def test_reconstruct_from_deltas(theta):
    xs = _stream(3)
    td, _, ts = tdelta.delta_encode_sequence(torch.from_numpy(xs), theta)
    jd, _, _ = jdelta.delta_encode_sequence(jnp.asarray(xs), theta)
    rec = tdelta.reconstruct_from_deltas(td)
    # cumulative sums in fp32: the two libraries may associate differently
    np.testing.assert_allclose(rec.numpy(),
                               np.asarray(jdelta.reconstruct_from_deltas(jd)),
                               rtol=1e-6, atol=1e-6)
    # the running sum of deltas is the state memory, up to fp32 rounding
    np.testing.assert_allclose(rec[-1].numpy(), ts.memory.numpy(),
                               atol=1e-5)
    init = torch.ones(xs.shape[1:])
    rec0 = tdelta.reconstruct_from_deltas(td, init=init)
    np.testing.assert_allclose(rec0.numpy(), rec.numpy() + 1.0, atol=1e-5)


def test_delta_encode_ste_forward_and_gradient():
    x = torch.from_numpy(_stream(4)[0]).requires_grad_(True)
    mem = tdelta.DeltaState(torch.zeros_like(x) + 0.1)
    out = tdelta.delta_encode_ste(x, mem, 0.25)
    ref = tdelta.delta_encode(x.detach(), mem, 0.25)
    _eq(out.delta.detach().numpy(), ref.delta.numpy())
    out.delta.sum().backward()
    _eq(x.grad.numpy(), np.ones(x.shape, np.float32))


# -- thresholds -------------------------------------------------------------

def test_threshold_policy_matches():
    for jp, tp in [
        (jthr.ThresholdPolicy.global_q88(64), tthr.ThresholdPolicy.global_q88(64)),
        (jthr.ThresholdPolicy.dual_q88(32, 128),
         tthr.ThresholdPolicy.dual_q88(32, 128)),
        (jthr.ThresholdPolicy(0.1, 0.2, per_layer_x=(0.3,)),
         tthr.ThresholdPolicy(0.1, 0.2, per_layer_x=(0.3,))),
    ]:
        assert jp.layer_thetas(3) == tp.layer_thetas(3)
        assert jp.has_per_layer == tp.has_per_layer
        assert (jp.theta_x, jp.theta_h) == (tp.theta_x, tp.theta_h)
    assert tthr.q88(64) == jthr.q88(64) == 0.25
    assert tthr.layer_theta((0.1, 0.2), 1) == 0.2
    assert tthr.layer_theta(0.3, 5) == 0.3


@pytest.mark.parametrize("theta", [0.0, 1.0 / 256, 0.1, 0.9])
@pytest.mark.parametrize("fired", [0.0, 0.05, 0.3, 0.99])
@pytest.mark.parametrize("target", [0.1, 0.5])
def test_dynamic_threshold_within_one_ulp(theta, fired, target):
    j = np.float32(jthr.dynamic_threshold(jnp.float32(theta),
                                          jnp.float32(fired), target))
    t = tthr.dynamic_threshold(torch.tensor(theta), torch.tensor(fired),
                               target).numpy()
    assert abs(float(j) - float(t)) <= np.spacing(np.float32(max(j, t)))
    if fired > target and theta == 0.0:
        assert t > 0          # the one-LSB floor lifts an absorbing zero


# -- sparsity and the Eq. 5-8 model ------------------------------------------

DIMS = [(40, 48, 2, "gru"), (40, 768, 2, "gru"), (14, 256, 2, "gru"),
        (40, 160, 1, "lstm"), (64, 64, 2, "rwkv6"), (32, 96, 2, "rglru")]


@pytest.mark.parametrize("i,h,l,cell", DIMS)
def test_cell_dims_match(i, h, l, cell):
    jd = jsparsity.cell_dims(cell, i, h, l)
    td = tsparsity.cell_dims(cell, i, h, l)
    for attr in ("x_weight_volume", "h_weight_volume",
                 "params_per_timestep_ops", "n_params", "gates"):
        assert getattr(jd, attr) == getattr(td, attr), attr
    for gx, gh in [(0.0, 0.0), (0.3, 0.7), (0.9, 0.95)]:
        assert jsparsity.effective_sparsity(jd, gx, gh) == \
            tsparsity.effective_sparsity(td, gx, gh)
        je = jperf.estimate_stack(jd, gx, gh)
        te = tperf.estimate_stack(td, gx, gh)
        assert dataclasses.astuple(je) == dataclasses.astuple(te)
        assert jperf.dram_traffic_bytes_per_timestep(jd, gx, gh, 4) == \
            tperf.dram_traffic_bytes_per_timestep(td, gx, gh, 4)
        assert jperf.estimate_batched_tile(jd, gx, gh, 8) == \
            tperf.estimate_batched_tile(td, gx, gh, 8)
    assert tsparsity.CELL_GATES == jsparsity.CELL_GATES
    assert sorted(tsparsity.CELL_PROJ_VOLUMES) == \
        sorted(jsparsity.CELL_PROJ_VOLUMES)


def test_paper_network_weight_count():
    d = tsparsity.cell_dims("gru", 40, 768, 2)
    assert d.n_params == 3 * 768 * (40 + 768) + 3 * 768 * 1536 == 5_400_576


def test_unknown_cell_dims_raise():
    with pytest.raises(ValueError, match="unknown cell family"):
        tsparsity.cell_dims("mamba", 1, 1, 1)


@pytest.mark.parametrize("backend", ["dense", "fused", "fused_q8",
                                     "fused_q4", "fused_batch"])
def test_spec_for_backend_and_accelerator(backend):
    js = jperf.spec_for_backend(jperf.EDGEDRNN, backend)
    ts = tperf.spec_for_backend(tperf.EDGEDRNN, backend)
    for attr in ("k_pes", "peak_ops", "mem_bounded_peak_ops",
                 "w_weight_bits"):
        assert getattr(js, attr) == getattr(ts, attr)
    for gamma in (0.0, 0.5, 0.9):
        assert jperf.delta_unit_latency_cycles(768, gamma, js) == \
            tperf.delta_unit_latency_cycles(768, gamma, ts)
        assert jperf.normalized_batch1_throughput(gamma, 4, js) == \
            tperf.normalized_batch1_throughput(gamma, 4, ts)
    assert jperf.union_sparsity(0.9, 8) == tperf.union_sparsity(0.9, 8)
    assert tperf.backend_weight_bits("gru") == jperf.backend_weight_bits("gru")


# -- backend registry --------------------------------------------------------

def test_registry_lists_the_seven_gru_backends_in_order():
    assert tbackends.list_backends("gru") == jbackends.list_backends("gru")
    assert len(tbackends.list_backends("gru")) == 7
    for name in tbackends.list_backends("gru"):
        js, ts = jbackends.get_backend(name), tbackends.get_backend(name)
        for attr in ("m_init", "weight_bits", "weight_fetch", "cell"):
            assert getattr(js, attr) == getattr(ts, attr), (name, attr)


def test_registry_rejections():
    with pytest.raises(ValueError, match="use 'fused'"):
        tbackends.get_backend("blocksparse")
    with pytest.raises(ValueError, match="unknown gru backend"):
        tbackends.get_backend("nope")
    for cell in ("rwkv6", "rglru"):
        assert tbackends.list_backends(cell) == ("dense", "fused")
        assert tbackends.get_backend("fused", cell=cell).cell == cell
    with pytest.raises(ValueError, match="unknown mamba backend"):
        tbackends.get_backend("fused", cell="mamba")
    spec = tbackends.get_backend("dense")
    with pytest.raises(ValueError, match="already registered"):
        tbackends.register_backend(spec)
    with pytest.raises(ValueError, match="leading stream axis"):
        tbackends.require_stream_tile(torch.zeros(4), "fused_q8_batch")
    tbackends.require_stream_tile(torch.zeros(1, 4), "fused_q8_batch")


# -- fixed-point grids and LUTs ----------------------------------------------

@pytest.mark.parametrize("fmt", ["ACT_Q88", "WGT_Q17", "WGT_Q13", "LUT_Q14"])
def test_quantize_bitwise(fmt):
    x = np.random.default_rng(6).normal(0, 3, 4096).astype(np.float32)
    x[:8] = [0.5 / 256, 1.5 / 256, -0.5 / 256, 2.5, -2.5, 1e3, -1e3, 0.0]
    jf, tf = getattr(jfq, fmt), getattr(tfq, fmt)
    assert (jf.bits, jf.scale, jf.min_val, jf.max_val) == \
        (tf.bits, tf.scale, tf.min_val, tf.max_val)
    _eq(jfq.quantize(jnp.asarray(x), jf), tfq.quantize(torch.from_numpy(x),
                                                       tf).numpy())
    _eq(jfq.to_int(jnp.asarray(x), jf), tfq.to_int(torch.from_numpy(x),
                                                   tf).numpy())


def test_fake_quant_is_straight_through():
    x = torch.linspace(-1, 1, 33, requires_grad=True)
    y = tfq.fake_quant(x, tfq.WGT_Q17)
    _eq(y.detach().numpy(), tfq.quantize(x.detach(), tfq.WGT_Q17).numpy())
    y.sum().backward()
    _eq(x.grad.numpy(), np.ones(33, np.float32))
    assert tfq.weight_format_for_bits(4) == tfq.WGT_Q13
    with pytest.raises(ValueError, match="no weight grid"):
        tfq.weight_format_for_bits(5)


@pytest.mark.parametrize("fn", ["lut_sigmoid", "lut_tanh"])
@pytest.mark.parametrize("frac_bits", [4, 8])
def test_lut_tables_bitwise_over_the_whole_q88_grid(fn, frac_bits):
    # every one of the 2**17 Q8.8 inputs: torch's and XLA's sigmoid/tanh
    # differ by a few ulps in places, never across a LUT rounding boundary
    jt = np.asarray(getattr(jlut, fn)(frac_bits).table())
    tt = getattr(tlut, fn)(frac_bits).table().numpy()
    assert jt.shape == tt.shape == (2 ** 17,)
    _eq(jt, tt)
    x = torch.linspace(-3, 3, 97, requires_grad=True)
    getattr(tlut, fn)(frac_bits)(x).sum().backward()
    exact = torch.sigmoid if fn == "lut_sigmoid" else torch.tanh
    xe = x.detach().requires_grad_(True)
    exact(xe).sum().backward()
    _eq(x.grad.numpy(), xe.grad.numpy())
