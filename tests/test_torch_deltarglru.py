"""The port's delta-RG-LRU cell (``cell="rglru"``), its models module, config
recipe, programs and engine, against the JAX package and against the port's
own block decode, on the CPU at D = W = 64, 1-2 layers.

* θ = 0: the port's ``dense`` backend is bitwise the port's
  ``rglru_block_decode`` (both call ``rglru_gates``; the dense backend
  spells the recurrence as the decode does), and the conv history it
  carries is the decode's.
* ``fused`` tracks ``dense`` within 2e-5 with identical firing.
* Against the JAX package: outputs within 1e-5 at θ = 0; at θ > 0 both are
  fed the same state each step (lockstep), since one ulp can flip a
  threshold decision. Engine reports: counts and names exactly, the fp32
  accounting within 1e-6 relative.

Weights go across with ``model_from_numpy``; inputs are made with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_9b as jcfg
from repro.core import backends as jbackends
from repro.core import deltarglru as jcell
from repro.core import program as jprogram
from repro.models import gru_rnn as jmodels
from repro.models import rglru as jrglru
from repro.serve import engine as jengine
from repro_torch.configs import recurrentgemma_9b as tcfg
from repro_torch.core import backends as tbackends
from repro_torch.core import deltarglru as tcell
from repro_torch.core import program as tprogram
from repro_torch.core.perf_model import dram_traffic_bytes_per_timestep
from repro_torch.core.sparsity import cell_dims
from repro_torch.core.thresholds import ThresholdPolicy
from repro_torch.models import gru_rnn as tmodels
from repro_torch.models import rglru as trglru
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

D, B, T = 64, 2, 8
TOL_JAX = 1e-5
TOL_FUSED = 2e-5
EXACT_FLOAT_KEYS = ("theta_x", "theta_h", "poison_steps", "bad_state_steps")


def _models(layers=2, seed=0):
    jm = jcell.init_deltarglru_model(jax.random.PRNGKey(seed), D, layers, 12)
    tm = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jm),
                                  device="cpu")
    return jm, tm


def _xs(t=T, b=B, scale=1.0, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, b, D)) * scale).astype(np.float32)


def _layer_dict(tm, li=0):
    return tcell.rglru_layer_dict(tm["rglru"][li])


def _decode_chain(pd, xs):
    """The port's exact dense decode: ``rglru_block_decode`` one step at a
    time with the state carried (the bitwise reference)."""
    st = trglru.init_rglru_state(xs.shape[1], D)
    ys = []
    for x in xs:
        y, st = trglru.rglru_block_decode(pd, x[:, None], st)
        ys.append(y[:, 0])
    return torch.stack(ys), st


def _delta_chain(pd, xs, theta=0.0, backend="dense"):
    st = trglru.init_rglru_delta_state(pd, (xs.shape[1],))
    ys, deltas = [], []
    for x in xs:
        out = trglru.rglru_block_decode_delta(pd, x, st, theta, theta,
                                              backend=backend)
        st = out.state
        ys.append(out.h)
        deltas.append((out.delta_x, out.delta_h))
    return torch.stack(ys), deltas, st


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def _jax_state(jprog, tstate):
    """The JAX program state holding the port state's values."""
    ref = jprog.init_state(tuple(tstate.layers[0].h.shape[:-1]))
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
    assert tbackends.list_backends("rglru") == jbackends.list_backends(
        "rglru") == ("dense", "fused")
    for name in ("dense", "fused"):
        js = jbackends.get_backend(name, cell="rglru")
        ts = tbackends.get_backend(name, cell="rglru")
        for attr in ("m_init", "weight_bits", "weight_fetch", "cell"):
            assert getattr(js, attr) == getattr(ts, attr), (name, attr)


# -- θ = 0: the dense backend is the block decode -------------------------------

def test_theta0_dense_is_bitwise_the_block_decode():
    _, tm = _models(layers=1)
    xs = torch.from_numpy(_xs())
    ref, _ = _decode_chain(_layer_dict(tm), xs)
    got, deltas, _ = _delta_chain(_layer_dict(tm), xs, 0.0)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    for dx, dh in deltas[1:]:
        assert float((dx != 0).float().mean()) > 0.95


def test_conv_history_carries():
    # CONV_WIDTH + 2 steps, so the window turns over completely
    _, tm = _models(layers=1)
    xs = torch.from_numpy(_xs(t=tcell.CONV_WIDTH + 2))
    _, st_m = _decode_chain(_layer_dict(tm), xs)
    _, _, st_d = _delta_chain(_layer_dict(tm), xs, 0.0)
    assert torch.equal(st_d.conv, st_m.conv)
    assert torch.equal(st_d.h, st_m.h)


# -- the fused path -------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.05])
def test_fused_tracks_dense(theta):
    _, tm = _models(layers=1)
    xs = torch.from_numpy(_xs(scale=0.5))
    ref, ref_d, _ = _delta_chain(_layer_dict(tm), xs, theta, "dense")
    got, got_d, _ = _delta_chain(_layer_dict(tm), xs, theta, "fused")
    _close(got, ref, TOL_FUSED)
    for (rx, rh), (gx, gh) in zip(ref_d, got_d):
        assert torch.equal(rx != 0, gx != 0)
        assert torch.equal(rh != 0, gh != 0)


def test_delta_groups_shapes_and_threshold_gating():
    _, tm = _models(layers=1)
    p = tm["rglru"][0]
    out = tcell.deltarglru_step(p, tcell.init_deltarglru_state(p, (B,)),
                                torch.from_numpy(_xs()[0]), 0.0, 0.0)
    assert out.delta_x.shape == (B, D)     # layer-input columns
    assert out.delta_h.shape == (B, D)     # post-conv gate columns
    _, deltas, _ = _delta_chain(_layer_dict(tm),
                                torch.from_numpy(_xs(scale=0.3)), 0.5)
    fired = np.mean([float((dx != 0).float().mean()) for dx, _ in deltas[1:]])
    assert fired < 0.7


# -- against the JAX package ------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_layer_chain_matches_jax(backend):
    jm, tm = _models(layers=1)
    xs = _xs(scale=0.5)
    jpd = jcell.rglru_layer_dict(jm["rglru"][0])
    got, _, _ = _delta_chain(_layer_dict(tm), torch.from_numpy(xs), 0.0,
                             backend)
    st = jrglru.init_rglru_delta_state(jpd, (B,))
    for t, x in enumerate(xs):
        out = jrglru.rglru_block_decode_delta(jpd, jnp.asarray(x), st, 0.0,
                                              0.0, backend=backend)
        st = out.state
        _close(got[t], out.h)


def test_block_apply_decode_and_conv_match_jax():
    jm, tm = _models(layers=1)
    jpd = jcell.rglru_layer_dict(jm["rglru"][0])
    pd = _layer_dict(tm)
    xs = _xs(t=7).transpose(1, 0, 2)                   # [B, T, D]
    jy, jst = jrglru.rglru_block_apply(jpd, jnp.asarray(xs))
    ty, tst = trglru.rglru_block_apply(pd, torch.from_numpy(xs))
    _close(ty, jy)
    _close(tst.h, jst.h)
    _close(tst.conv, jst.conv)
    # carry on from that state for three more steps, one at a time
    for x in _xs(t=3, seed=4):
        jy, jst = jrglru.rglru_block_decode(jpd, jnp.asarray(x)[:, None], jst)
        ty, tst = trglru.rglru_block_decode(pd, torch.from_numpy(x)[:, None],
                                            tst)
        _close(ty, jy)
        _close(tst.h, jst.h)
    w = np.random.default_rng(5).normal(size=(4, D)).astype(np.float32)
    jo, jh = jrglru._causal_conv(jnp.asarray(xs), jnp.asarray(w),
                                 jnp.zeros(D))
    to, th = trglru._causal_conv(torch.from_numpy(xs), torch.from_numpy(w),
                                 torch.zeros(D))
    _close(to, jo)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_program_sequence_matches_jax(backend):
    jm, tm = _models()
    xs = _xs()
    jprog = jprogram.compile_delta_program(jm, backend, cell="rglru")
    tprog = tprogram.compile_delta_program(tm, backend, cell="rglru",
                                           device="cpu")
    assert tprog.cell == "rglru" and tprog.device.type == "cpu"
    jy, jst, jstats = jprog.sequence(jnp.asarray(xs), 0.0, 0.0)
    ty, tst, tstats = tprog.sequence(torch.from_numpy(xs), 0.0, 0.0)
    assert ty.shape == (T, B, D)
    _close(ty, jy)
    for a, b in zip(_leaves(tst.stack), jax.tree_util.tree_leaves(jst.stack)):
        _close(a, b, TOL_JAX * max(1.0, float(np.abs(b).max())))
    assert float(tstats["gamma_dx"]) == float(jstats["gamma_dx"]) == 0.0
    assert float(tstats["gamma_dh"]) == float(jstats["gamma_dh"]) == 0.0
    _, _, stats = tprog.sequence(torch.from_numpy(xs), 0.25, 0.25)
    assert float(stats["gamma_dx"]) > 0.1


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_program_lockstep_above_theta0_matches_jax(backend):
    jm, tm = _models()
    xs = _xs(scale=0.5)
    jprog = jprogram.compile_delta_program(jm, backend, cell="rglru")
    tprog = tprogram.compile_delta_program(tm, backend, cell="rglru",
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


def test_state_tag_errors():
    _, tm = _models()
    dense = tprogram.compile_delta_program(tm, "dense", cell="rglru",
                                           device="cpu")
    fused = tprogram.compile_delta_program(tm, "fused", cell="rglru",
                                           device="cpu")
    x = torch.zeros(B, D)
    with pytest.raises(ValueError, match="backend"):
        dense.step(fused.init_state((B,)), x)
    with pytest.raises(TypeError, match="DeltaProgramState"):
        dense.step(tcell.init_deltarglru_stack_state(dense.layers, (B,)), x)
    assert tprogram.infer_cell(tm) == "rglru"


# -- engine -------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_engine_report_matches_jax(backend):
    jm, tm = _models()
    jprog = jprogram.compile_delta_program(jm, backend, cell="rglru")
    tprog = tprogram.compile_delta_program(tm, backend, cell="rglru",
                                           device="cpu")
    task = (D, D, 2, 12)
    je = jengine.DeltaStreamEngine(jprog, jmodels.GruTaskConfig(*task))
    te = tengine.DeltaStreamEngine(tprog, tmodels.GruTaskConfig(*task),
                                   device="cpu")
    xs = _xs(t=10, b=1)[:, 0]
    jsid, tsid = je.open_stream(), te.open_stream()
    _close(te.step_many(xs), np.asarray(je.step_many(xs)))
    js, ts = je.close_stream(jsid), te.close_stream(tsid)
    _same_report(js, ts)
    assert ts["gamma_dx"] == 0.0 and ts["gamma_dh"] == 0.0
    dense_bytes = dram_traffic_bytes_per_timestep(
        cell_dims("rglru", D, D, 2), 0.0, 0.0, w_weight_bits=32)
    assert ts["mean_weight_bytes_per_step"] == pytest.approx(dense_bytes)
    _same_report(je.report(), te.report())


def test_thresholded_session_sheds_bytes():
    _, tm = _models()
    prog = tprogram.compile_delta_program(tm, "dense", cell="rglru",
                                          device="cpu")
    eng = tengine.DeltaStreamEngine(prog, tmodels.GruTaskConfig(D, D, 2, 12),
                                    device="cpu",
                                    thresholds=ThresholdPolicy(0.25, 0.25))
    rng = np.random.default_rng(1)
    eng.step_many(np.cumsum(rng.normal(0, 0.05, (24, D)), 0).astype(
        np.float32))
    rep = eng.report()
    dense_bytes = dram_traffic_bytes_per_timestep(
        cell_dims("rglru", D, D, 2), 0.0, 0.0, w_weight_bits=32)
    assert rep["gamma_dx"] > 0.0
    assert rep["mean_weight_bytes_per_step"] < dense_bytes


# -- config recipe and weights ----------------------------------------------------

def test_reduced_delta_recipe_matches_jax():
    jc, jm, jt = jcfg.reduced_delta_recipe(jax.random.PRNGKey(0))
    tc, tm, tt = tcfg.reduced_delta_recipe(0, device="cpu")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jcfg.CONFIG) == dataclasses.asdict(tcfg.CONFIG)
    assert (jt.input_size, jt.hidden_size, jt.num_layers, jt.output_size) \
        == (tt.input_size, tt.hidden_size, tt.num_layers, tt.output_size)
    assert len(jm["rglru"]) == len(tm["rglru"])
    for jl, tl in zip(jm["rglru"], tm["rglru"]):
        assert jl._fields == tl._fields
        for a, b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
    # λ from the same recipe: a = exp(-c softplus(λ)) lies in [0.9, 0.999]
    lam = tm["rglru"][0].lam
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def test_model_from_numpy_copies_every_field_bit_for_bit():
    jm, tm = _models()
    for jl, tl in zip(jm["rglru"], tm["rglru"]):
        assert isinstance(tl, tcell.RglruLayerParams)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the models-module dict spelling, with "lambda" for the lam field
    layer = {k: np.asarray(v) for k, v in
             jcell.rglru_layer_dict(jm["rglru"][0]).items()}
    assert "lambda" in layer and "lam" not in layer
    again = tmodels.model_from_numpy(
        {"rglru": [layer], "head": np.asarray(jm["head"]),
         "head_b": np.asarray(jm["head_b"])}, device="cpu")
    for a, b in zip(again["rglru"][0], tm["rglru"][0]):
        assert torch.equal(a, b)
    assert set(_layer_dict(tm)) == set(layer)
