"""The port's ``DeltaStreamEngine`` and ``GruStreamBatcher`` against the JAX
package, on the CPU, at I=40, H=48, 2 layers.

With ``fused_q8`` the engines' recurrent state is bitwise equal after a run,
and every output equals the port's head applied to the JAX package's own
hidden states bit for bit. Output against output, the two agree within
1e-6: the head is one fp32 matmul whose summation order each library
chooses. ``report()`` keys are equal key by key: steps, counters, names
and thresholds exactly, the fp32 accounting (firing fractions, Eq. 7
latency and bytes) within 1e-6 relative — XLA compiles the JAX engine's
accounting, reorders its nested means, multiplies by reciprocals and
contracts multiply-adds, while the port evaluates it as written.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as jprogram
from repro.models import gru_rnn as jmodels
from repro.serve import engine as jengine
from repro.serve import scheduler as jscheduler
from repro_torch.core import program as tprogram
from repro_torch.core.thresholds import ThresholdPolicy
from repro_torch.models import gru_rnn as tmodels
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tscheduler

torch.set_num_threads(1)

H = 48
TOL_HEAD = 1e-6
EXACT_FLOAT_KEYS = ("theta_x", "theta_h", "poison_steps", "bad_state_steps")


def _setup(backend="fused_q8", theta=(0.25, 0.25), seed=0):
    jcfg = jmodels.GruTaskConfig(40, H, 2, 12, theta_x=theta[0],
                                 theta_h=theta[1])
    tcfg = tmodels.GruTaskConfig(40, H, 2, 12, theta_x=theta[0],
                                 theta_h=theta[1])
    jp = jmodels.init_gru_model(jax.random.PRNGKey(seed), jcfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return (jprogram.compile_deltagru(jp, backend), jcfg,
            tprogram.compile_deltagru(tp, backend, device="cpu"), tcfg)


def _frames(t, n, seed=1):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 0.3, (t, n, 40)), 0).astype(np.float32)


def _leaves(state):
    out = []
    for layer in state.layers:
        out += [layer.h, layer.x_mem.memory, layer.h_mem.memory, layer.m]
    return out


def _same_report(jr, tr):
    assert jr.keys() == tr.keys()
    for k in jr:
        if isinstance(jr[k], float) and k not in EXACT_FLOAT_KEYS:
            assert tr[k] == pytest.approx(jr[k], rel=1e-6), k
        else:
            assert jr[k] == tr[k], k


@pytest.mark.parametrize("n", [1, 4])
def test_engine_fused_q8_matches_jax(n):
    jprog, jcfg, tprog, tcfg = _setup()
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=n)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=n, device="cpu")
    xs = _frames(20, n)
    if n == 1:
        xs = xs[:, 0]
    jo = np.asarray(je.step_many(xs))
    to = te.step_many(xs)
    for a, b in zip(_leaves(je.state), _leaves(te.state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # outputs: the port's head on the JAX package's hidden states, bitwise
    jys, _, _ = jprog.sequence(jnp.asarray(xs.reshape(20, n, 40)), 0.25, 0.25)
    head = torch.stack([torch.from_numpy(np.array(y)) @ tprog.head
                        + tprog.head_b for y in jys])
    np.testing.assert_array_equal(to.reshape(head.shape).numpy(),
                                  head.numpy())
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=TOL_HEAD)
    _same_report(je.report(), te.report())
    assert te.report()["backend"] == ("fused_q8" if n == 1
                                      else "fused_q8_batch")


@pytest.mark.parametrize("backend", ["fused", "fused_q4"])
def test_engine_other_backends_match_jax(backend):
    # fp32 at theta=0 (no threshold decision can flip), int4 at 0.25
    theta = (0.0, 0.0) if backend == "fused" else (0.25, 0.25)
    jprog, jcfg, tprog, tcfg = _setup(backend, theta)
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=3)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=3, device="cpu")
    xs = _frames(12, 3)
    for x in xs:
        jo = np.asarray(je.step(x))
        to = te.step(x)
        np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=1e-5)
    _same_report(je.report(), te.report())


def test_batcher_drains_mixed_lengths_like_jax():
    jprog, jcfg, tprog, tcfg = _setup()
    jb = jscheduler.GruStreamBatcher(
        jengine.DeltaStreamEngine(jprog, jcfg, n_streams=4))
    tb = tscheduler.GruStreamBatcher(
        tengine.DeltaStreamEngine(tprog, tcfg, n_streams=4, device="cpu"))
    rng = np.random.default_rng(5)
    for i, t in enumerate(rng.integers(3, 15, 8)):
        fr = _frames(int(t), 1, seed=10 + i)[:, 0]
        assert jb.submit(fr) == tb.submit(fr)
    jd = {r.uid: r for r in jb.run_until_drained()}
    td = {r.uid: r for r in tb.run_until_drained()}
    assert jd.keys() == td.keys() and len(td) == 8
    assert jb.counters == tb.counters
    for uid, tr in td.items():
        jr = jd[uid]
        np.testing.assert_allclose(np.stack(tr.outputs),
                                   np.stack(jr.outputs), rtol=0,
                                   atol=TOL_HEAD)
        _same_report(jr.stats, tr.stats)
    _same_report(jb.engine.report(), tb.engine.report())
    assert tb.queue_depth() == 0 and tb.active_slots() == 0
    assert tb.free_slots() == 4


def test_engine_guards_non_finite_frames_like_jax():
    jprog, jcfg, tprog, tcfg = _setup()
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=2)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=2, device="cpu")
    xs = _frames(8, 2)
    xs[3, 1, 7] = np.nan
    xs[5, 0, 0] = np.inf
    jo = np.asarray(je.step_many(xs))
    to = te.step_many(xs)
    assert torch.isfinite(to).all()
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=TOL_HEAD)
    assert te.report()["poison_steps"] == je.report()["poison_steps"] == 2.0
    assert te.report()["bad_state_steps"] == 0.0
    with pytest.raises(ValueError, match="non-finite"):
        tscheduler.GruStreamBatcher(te).submit(xs[:, 0])


def test_per_layer_and_dynamic_thresholds_match_jax():
    jprog, jcfg, tprog, tcfg = _setup()
    policy = dict(theta_x=0.1, theta_h=0.2, per_layer_x=(0.05,),
                  per_layer_h=(0.3, 0.1))
    je = jengine.DeltaStreamEngine(
        jprog, jcfg, thresholds=jengine.ThresholdPolicy(**policy))
    te = tengine.DeltaStreamEngine(tprog, tcfg,
                                   thresholds=ThresholdPolicy(**policy),
                                   device="cpu")
    xs = _frames(10, 1)[:, 0]
    np.testing.assert_allclose(te.step_many(xs).numpy(),
                               np.asarray(je.step_many(xs)), atol=TOL_HEAD)
    _same_report(je.report(), te.report())
    with pytest.raises(ValueError, match="per-layer"):
        te.set_theta_h(0.5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tengine.DeltaStreamEngine(tprog, tcfg, device="cpu",
                                  thresholds=ThresholdPolicy(**policy),
                                  dynamic_target_fired=0.2)
    # the dynamic controller: the same Θ_h trajectory within 1e-6
    jd = jengine.DeltaStreamEngine(jprog, jcfg, dynamic_target_fired=0.1)
    td = tengine.DeltaStreamEngine(tprog, tcfg, dynamic_target_fired=0.1,
                                   device="cpu")
    for x in xs:
        jd.step(x)
        td.step(x)
        assert td.theta_h == pytest.approx(jd.theta_h, rel=1e-6)
    assert td.theta_h != 0.25                      # it moved


def test_sessions_snapshot_and_rollback():
    _, _, tprog, tcfg = _setup()
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=2, device="cpu")
    xs = _frames(12, 2)
    assert te.open_stream() == 0 and te.open_stream() == 1
    with pytest.raises(RuntimeError, match="busy"):
        te.open_stream()
    te.step_many(xs[:4])
    te.snapshot_streams([1])
    after = te.step_many(xs[4:8])
    assert te.rollback_stream(1) == 4
    replay = te.step_many(xs[4:8])
    np.testing.assert_array_equal(replay[:, 1].numpy(), after[:, 1].numpy())
    stats = te.close_stream(0)
    assert stats["steps"] == 12 and stats["stream"] == 0
    with pytest.raises(ValueError, match="not open"):
        te.close_stream(0)
    # a reopened slot starts from a fresh state, its neighbour untouched
    assert te.open_stream() == 0
    fresh = tprog.init_state((2,))
    for a, b in zip(_leaves(te.state), _leaves(fresh)):
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    te.set_theta_h(0.5)
    assert te.theta_h == 0.5
    te.reset()
    assert te.report()["steps"] == 0 and te.free_streams == [0, 1]


def test_engine_input_validation_and_routing():
    _, _, tprog, tcfg = _setup("fused")
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=3, device="cpu")
    assert te.backend == "fused_batch" and te.report()["weight_fetch"] == "tile"
    with pytest.raises(ValueError, match="cross-contaminate"):
        te.step(np.zeros(40, np.float32))
    with pytest.raises(ValueError, match="broadcast"):
        te.step_many(np.zeros((2, 40), np.float32))
    with pytest.raises(ValueError, match="conflicts"):
        tengine.DeltaStreamEngine(tprog, tcfg, backend="dense", device="cpu")
    one = tengine.DeltaStreamEngine(tprog, tcfg, device="cpu")
    assert one.backend == "fused" and one.step(np.ones(40)).shape == (12,)
    dense = tengine.DeltaStreamEngine(
        tprogram.compile_deltagru(
            {"gru": tprog.layers, "head": tprog.head,
             "head_b": tprog.head_b}, "dense", device="cpu"),
        tcfg, n_streams=2, device="cpu")
    assert dense.backend == "dense"                 # no tile sibling
    buf = np.ones((1, 40), np.float32)
    out = one.step(buf)
    buf[:] = 100.0                                   # the engine kept a copy
    assert torch.isfinite(out).all()
