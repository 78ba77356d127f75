"""The port's delta-RWKV6 cell (``cell="rwkv6"``), its models module, config
recipe, programs and engine, against the JAX package and against the port's
own dense decode, on the CPU at D = 64 (one head of 64; two at D = 128),
1-2 layers.

* θ = 0: the port's ``dense`` backend is bitwise the port's dense decode
  (``rwkv_time_mix`` at T = 1): both share ``mix_streams`` /
  ``group_norm_heads`` and the WKV scan.
* ``fused`` tracks ``dense`` within 2e-5 with identical firing (the JAX
  package's own bound between the two).
* Against the JAX package: outputs within 1e-5 at θ = 0 (the libraries sum
  in other orders); at θ > 0 one ulp can flip a threshold decision, so
  there both are fed the same state each step (lockstep). Engine reports:
  counts and names exactly, the fp32 accounting within 1e-6 relative.

Weights go across with ``model_from_numpy``; inputs are made with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_1_6b as jcfg
from repro.core import backends as jbackends
from repro.core import deltarwkv as jcell
from repro.core import program as jprogram
from repro.models import gru_rnn as jmodels
from repro.models import rwkv as jrwkv
from repro.serve import engine as jengine
from repro_torch.configs import rwkv6_1_6b as tcfg
from repro_torch.core import backends as tbackends
from repro_torch.core import deltarwkv as tcell
from repro_torch.core import program as tprogram
from repro_torch.core.perf_model import dram_traffic_bytes_per_timestep
from repro_torch.core.sparsity import cell_dims
from repro_torch.core.thresholds import ThresholdPolicy
from repro_torch.kernels import ops
from repro_torch.models import gru_rnn as tmodels
from repro_torch.models import rwkv as trwkv
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

D, B, T = 64, 2, 6
TOL_JAX = 1e-5
TOL_FUSED = 2e-5
EXACT_FLOAT_KEYS = ("theta_x", "theta_h", "poison_steps", "bad_state_steps")


def _models(d=D, layers=2, seed=0):
    jm = jcell.init_deltarwkv_model(jax.random.PRNGKey(seed), d, layers, 12)
    tm = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jm),
                                  device="cpu")
    return jm, tm


def _xs(t=T, b=B, d=D, scale=1.0, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, b, d)) * scale).astype(np.float32)


def _smooth(t, d, seed=1):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 0.05, (t, d)), 0).astype(np.float32)


def _decode_chain(pd, xs):
    """The port's exact dense decode: ``rwkv_time_mix`` one step at a time
    with the state carried (the bitwise reference)."""
    st = trwkv.init_rwkv_state(xs.shape[1], xs.shape[2])
    ys = []
    for x in xs:
        y, last, wkv = trwkv.rwkv_time_mix(pd, x[:, None], st)
        st = trwkv.RwkvState(tm_shift=last, cm_shift=st.cm_shift, wkv=wkv)
        ys.append(y[:, 0])
    return torch.stack(ys)


def _delta_chain(pd, xs, theta=0.0, backend="dense"):
    st = trwkv.init_rwkv_delta_state(pd, (xs.shape[1],))
    ys, deltas = [], []
    for x in xs:
        out = trwkv.rwkv_time_mix_delta(pd, x, st, theta, theta,
                                        backend=backend)
        st = out.state
        ys.append(out.h)
        deltas.append((out.delta_x, out.delta_h))
    return torch.stack(ys), deltas


def _layer_dict(tm, li=0):
    return tcell.rwkv_layer_dict(tm["rwkv6"][li])


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def _jax_state(jprog, tstate):
    """The JAX program state holding the port state's values."""
    ref = jprog.init_state(tuple(tstate.layers[0].shift.shape[:-1]))
    leaves = [jnp.asarray(t.numpy()) for t in _leaves(tstate.stack)]
    stack = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref.stack), leaves)
    return dataclasses.replace(ref, stack=stack)


def _close(got, want, tol=TOL_JAX):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _same_report(jr, tr):
    assert jr.keys() == tr.keys()
    for k in jr:
        if isinstance(jr[k], float) and k not in EXACT_FLOAT_KEYS:
            assert tr[k] == pytest.approx(jr[k], rel=1e-6), k
        else:
            assert jr[k] == tr[k], k


# -- registry -----------------------------------------------------------------

def test_registry_matches_jax():
    assert tbackends.list_backends("rwkv6") == jbackends.list_backends(
        "rwkv6") == ("dense", "fused")
    for name in ("dense", "fused"):
        js = jbackends.get_backend(name, cell="rwkv6")
        ts = tbackends.get_backend(name, cell="rwkv6")
        for attr in ("m_init", "weight_bits", "weight_fetch", "cell"):
            assert getattr(js, attr) == getattr(ts, attr), (name, attr)
    assert tbackends.get_backend("fused", cell="rwkv6").m_init == "zero"


# -- θ = 0: the dense backend is the dense decode ------------------------------

@pytest.mark.parametrize("d", [64, 128])
def test_theta0_dense_is_bitwise_the_dense_decode(d):
    _, tm = _models(d=d, layers=1)
    xs = torch.from_numpy(_xs(d=d))
    ref = _decode_chain(_layer_dict(tm), xs)
    got, deltas = _delta_chain(_layer_dict(tm), xs, 0.0)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    # at θ = 0 every component fires every step (|s - ŝ| >= 0)
    for dx, dh in deltas[1:]:
        assert float((dx != 0).float().mean()) > 0.95
        assert float((dh != 0).float().mean()) > 0.95


# -- the fused path -------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.05])
def test_fused_tracks_dense(theta):
    _, tm = _models(layers=1)
    xs = torch.from_numpy(_xs(scale=0.5))
    ref, ref_d = _delta_chain(_layer_dict(tm), xs, theta, "dense")
    got, got_d = _delta_chain(_layer_dict(tm), xs, theta, "fused")
    _close(got, ref, TOL_FUSED)
    for (rx, rh), (gx, gh) in zip(ref_d, got_d):
        assert torch.equal(rx != 0, gx != 0)
        assert torch.equal(rh != 0, gh != 0)


def test_delta_groups_shapes_and_threshold_gating():
    _, tm = _models(layers=1)
    p = tm["rwkv6"][0]
    out = tcell.deltarwkv_step(p, tcell.init_deltarwkv_state(p, (B,)),
                               torch.from_numpy(_xs()[0]), 0.0, 0.0)
    assert out.delta_x.shape == (B, 3 * D)    # r/k/v columns
    assert out.delta_h.shape == (B, D)        # decay-LoRA columns
    _, deltas = _delta_chain(_layer_dict(tm),
                             torch.from_numpy(_xs(scale=0.3)), 0.5)
    fired = np.mean([float((dx != 0).float().mean()) for dx, _ in deltas[1:]])
    assert fired < 0.7


# -- against the JAX package ------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_layer_chain_matches_jax(backend):
    jm, tm = _models(layers=1)
    xs = _xs(scale=0.5)
    jpd = jcell.rwkv_layer_dict(jm["rwkv6"][0])
    got, _ = _delta_chain(_layer_dict(tm), torch.from_numpy(xs), 0.0,
                          backend)
    st = jrwkv.init_rwkv_delta_state(jpd, (B,))
    for t, x in enumerate(xs):
        out = jrwkv.rwkv_time_mix_delta(jpd, jnp.asarray(x), st, 0.0, 0.0,
                                        backend=backend)
        st = out.state
        _close(got[t], out.h)


def test_time_mix_and_channel_mix_match_jax():
    jm, tm = _models(layers=1)
    xs = _xs(t=5).transpose(1, 0, 2)                   # [B, T, D]
    jpd = jcell.rwkv_layer_dict(jm["rwkv6"][0])
    jst = jrwkv.init_rwkv_state(B, D)
    jy, jlast, jwkv = jrwkv.rwkv_time_mix(jpd, jnp.asarray(xs), jst)
    ty, tlast, twkv = trwkv.rwkv_time_mix(
        _layer_dict(tm), torch.from_numpy(xs), trwkv.init_rwkv_state(B, D))
    _close(ty, jy)
    _close(twkv, jwkv)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    jcm = jrwkv.init_rwkv_channel_mix(jax.random.PRNGKey(3), D, 2 * D)
    tcm = {k: torch.from_numpy(np.array(v)) for k, v in jcm.items()}
    last = np.random.default_rng(2).normal(size=(B, D)).astype(np.float32)
    jo, jl = jrwkv.rwkv_channel_mix(jcm, jnp.asarray(xs), jnp.asarray(last))
    to, tl = trwkv.rwkv_channel_mix(tcm, torch.from_numpy(xs),
                                    torch.from_numpy(last))
    _close(to, jo)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_program_sequence_matches_jax(backend):
    jm, tm = _models()
    xs = _xs(t=8)
    jprog = jprogram.compile_delta_program(jm, backend, cell="rwkv6")
    tprog = tprogram.compile_delta_program(tm, backend, cell="rwkv6",
                                           device="cpu")
    assert tprog.cell == "rwkv6" and tprog.device.type == "cpu"
    assert (tprog.num_layers, tprog.input_size, tprog.hidden_size) == (
        2, D, D)
    jy, jst, jstats = jprog.sequence(jnp.asarray(xs), 0.0, 0.0)
    ty, tst, tstats = tprog.sequence(torch.from_numpy(xs), 0.0, 0.0)
    assert ty.shape == (8, B, D)
    _close(ty, jy)
    for a, b in zip(_leaves(tst.stack), jax.tree_util.tree_leaves(jst.stack)):
        _close(a, b, TOL_JAX * max(1.0, float(np.abs(b).max())))
    assert float(tstats["gamma_dx"]) == float(jstats["gamma_dx"]) == 0.0
    assert float(tstats["gamma_dh"]) == float(jstats["gamma_dh"]) == 0.0
    _, _, stats = tprog.sequence(torch.from_numpy(xs), 0.25, 0.25)
    assert float(stats["gamma_dx"]) > 0.1


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_program_lockstep_above_theta0_matches_jax(backend):
    # one layer, so each compared step is one layer step from the same
    # state: across layers the two libraries' ulps compound through the
    # group norm
    jm, tm = _models(layers=1)
    xs = _xs(t=8, scale=0.5)
    jprog = jprogram.compile_delta_program(jm, backend, cell="rwkv6")
    tprog = tprogram.compile_delta_program(tm, backend, cell="rwkv6",
                                           device="cpu")
    st = tprog.init_state((B,))
    for x in xs:
        ty, tnew, tdeltas = tprog.step(st, torch.from_numpy(x), 0.1, 0.1)
        jy, jnew, jdeltas = jprog.step(_jax_state(jprog, st),
                                       jnp.asarray(x), 0.1, 0.1)
        _close(ty, jy)
        for (tdx, tdh), (jdx, jdh) in zip(tdeltas, jdeltas):
            np.testing.assert_array_equal(tdx.numpy() != 0,
                                          np.asarray(jdx) != 0)
            np.testing.assert_array_equal(tdh.numpy() != 0,
                                          np.asarray(jdh) != 0)
        for a, b in zip(_leaves(tnew.stack),
                        jax.tree_util.tree_leaves(jnew.stack)):
            _close(a, b, TOL_JAX * max(1.0, float(np.abs(b).max())))
        st = tnew


def test_state_tag_and_cross_cell_errors():
    _, tm = _models()
    dense = tprogram.compile_delta_program(tm, "dense", cell="rwkv6",
                                           device="cpu")
    fused = tprogram.compile_delta_program(tm, "fused", cell="rwkv6",
                                           device="cpu")
    x = torch.zeros(B, D)
    with pytest.raises(ValueError, match="backend"):
        dense.step(fused.init_state((B,)), x)
    with pytest.raises(TypeError, match="DeltaProgramState"):
        dense.step(tcell.init_deltarwkv_stack_state(dense.layers, (B,)), x)
    from repro_torch.core.deltarglru import init_deltarglru_model
    rg = tprogram.compile_delta_program(
        init_deltarglru_model(0, D, 1, 12, device="cpu"), "dense",
        cell="rglru", device="cpu")
    with pytest.raises(ValueError, match="cell"):
        dense.step(rg.init_state((B,)), x)
    with pytest.raises(ValueError, match="pass cell='rwkv6'"):
        tprogram.compile_delta_program(tm, "dense", cell="rglru",
                                       device="cpu")
    assert tprogram.infer_cell(tm) == "rwkv6"


# -- engine -------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_engine_report_matches_jax(backend):
    jm, tm = _models()
    jprog = jprogram.compile_delta_program(jm, backend, cell="rwkv6")
    tprog = tprogram.compile_delta_program(tm, backend, cell="rwkv6",
                                           device="cpu")
    task = (D, D, 2, 12)
    je = jengine.DeltaStreamEngine(jprog, jmodels.GruTaskConfig(*task))
    te = tengine.DeltaStreamEngine(tprog, tmodels.GruTaskConfig(*task),
                                   device="cpu")
    xs = _xs(t=10, b=1)[:, 0]
    jsid, tsid = je.open_stream(), te.open_stream()
    jo = np.asarray(je.step_many(xs))
    to = te.step_many(xs)
    _close(to, jo)
    js, ts = je.close_stream(jsid), te.close_stream(tsid)
    _same_report(js, ts)
    assert ts["steps"] == 10
    assert ts["gamma_dx"] == 0.0 and ts["gamma_dh"] == 0.0
    dense_bytes = dram_traffic_bytes_per_timestep(
        cell_dims("rwkv6", D, D, 2), 0.0, 0.0, w_weight_bits=32)
    assert ts["mean_weight_bytes_per_step"] == pytest.approx(dense_bytes)
    _same_report(je.report(), te.report())
    assert te.report()["cell"] == "rwkv6"


def test_thresholded_session_sheds_bytes_and_batches_without_a_sibling():
    _, tm = _models()
    prog = tprogram.compile_delta_program(tm, "fused", cell="rwkv6",
                                          device="cpu")
    task = tmodels.GruTaskConfig(D, D, 2, 12)
    eng = tengine.DeltaStreamEngine(prog, task, device="cpu",
                                    thresholds=ThresholdPolicy(0.25, 0.25))
    eng.step_many(_smooth(24, D))
    rep = eng.report()
    dense_bytes = dram_traffic_bytes_per_timestep(
        cell_dims("rwkv6", D, D, 2), 0.0, 0.0, w_weight_bits=32)
    assert rep["gamma_dx"] > 0.0
    assert rep["mean_weight_bytes_per_step"] < dense_bytes
    # no fused_batch for the LM cells: a tile keeps "fused"
    eng4 = tengine.DeltaStreamEngine(prog, task, n_streams=4, device="cpu")
    assert eng4.backend == "fused" and eng4.report()["weight_fetch"] == \
        "stream"
    ops.reset_launch_counts()
    out = eng4.step_many(np.stack([_smooth(5, D, seed=s) for s in range(4)],
                                  1))
    assert out.shape == (5, 4, 12) and torch.isfinite(out).all()
    assert sum(ops.launch_counts().values()) == 0      # CPU: plain versions


# -- config recipe and weights ----------------------------------------------------

def test_reduced_delta_recipe_matches_jax():
    jc, jm, jt = jcfg.reduced_delta_recipe(jax.random.PRNGKey(0))
    tc, tm, tt = tcfg.reduced_delta_recipe(0, device="cpu")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jcfg.CONFIG) == dataclasses.asdict(tcfg.CONFIG)
    assert (jt.input_size, jt.hidden_size, jt.num_layers, jt.output_size) \
        == (tt.input_size, tt.hidden_size, tt.num_layers, tt.output_size)
    assert len(jm["rwkv6"]) == len(tm["rwkv6"])
    for jl, tl in zip(jm["rwkv6"], tm["rwkv6"]):
        assert jl._fields == tl._fields
        for a, b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape) and b.dtype == \
                torch.float32
    assert tuple(jm["head"].shape) == tuple(tm["head"].shape)


def test_model_from_numpy_copies_every_field_bit_for_bit():
    jm, tm = _models()
    for jl, tl in zip(jm["rwkv6"], tm["rwkv6"]):
        assert isinstance(tl, tcell.RwkvLayerParams)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the models-module dict spelling of a layer
    tree = {"rwkv6": [{k: np.asarray(v) for k, v in
                       jcell.rwkv_layer_dict(jm["rwkv6"][0]).items()}],
            "head": np.asarray(jm["head"]), "head_b": np.asarray(jm["head_b"])}
    again = tmodels.model_from_numpy(tree, device="cpu")
    for a, b in zip(again["rwkv6"][0], tm["rwkv6"][0]):
        assert torch.equal(a, b)
