"""The port's DeltaLSTM stack, programs, exporter, models, engine and batcher
against the JAX package, on the CPU, at small widths (I=40, H in {48, 160},
1-2 layers).

Weights go across with ``model_from_numpy``; inputs are made with numpy.
The JAX side runs as its own tests run it: the Pallas bodies in interpret
mode (``program.with_interpret(True)``) at short T, its jnp oracles (the
default off a TPU) over longer sequences.

* int8 / int4 (``fused_q8*`` / ``fused_q4*``): bitwise, cell state
  included, at θ = 0 and at dual thresholds.
* fp32 (``dense``, ``fused*``): within 1e-5 at θ = 0 (the sums run in
  another order; 1e-5 is the JAX package's own batch-against-solo bound).
  At θ > 0 one ulp can flip a threshold decision and part the
  trajectories, so there both packages are fed the same inputs and state
  each step.
* Engine reports: counts and names exactly, the fp32 accounting within
  1e-6 relative (XLA compiles the JAX engine's accounting, reorders its
  nested means and multiplies by reciprocals); outputs within 1e-6 (the
  head is one fp32 matmul whose summation order each library chooses).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jbackends
from repro.core import deltalstm as jlstm
from repro.core import program as jprogram
from repro.core import sparsity as jsparsity
from repro.models import gru_rnn as jmodels
from repro.quant import export as jexport
from repro.serve import engine as jengine
from repro.serve import scheduler as jscheduler
from repro_torch.core import backends as tbackends
from repro_torch.core import deltalstm as tlstm
from repro_torch.core import program as tprogram
from repro_torch.core import sparsity as tsparsity
from repro_torch.core.delta import DeltaState
from repro_torch.kernels.engine_epilogue import nonfinite_rows
from repro_torch.models import gru_rnn as tmodels
from repro_torch.quant import export as texport
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tscheduler

torch.set_num_threads(1)

QUANT = ["fused_q8", "fused_q4", "fused_q8_batch", "fused_q4_batch"]
FP32 = ["dense", "fused", "fused_batch"]
TOL_F32 = 1e-5
TOL_HEAD = 1e-6
EXACT_FLOAT_KEYS = ("theta_x", "theta_h", "poison_steps", "bad_state_steps")


def _models(h, seed=0, layers=2, theta=(0.0, 0.0)):
    jcfg = jmodels.GruTaskConfig(40, h, layers, 12, theta_x=theta[0],
                                 theta_h=theta[1])
    tcfg = tmodels.GruTaskConfig(40, h, layers, 12, theta_x=theta[0],
                                 theta_h=theta[1])
    jp = jmodels.init_lstm_model(jax.random.PRNGKey(seed), jcfg)
    # random biases (the forget gate's stays near 1) exercise the bias
    # folding and the b4 rows
    rng = np.random.default_rng(seed)
    jp["lstm"] = [p._replace(b=p.b + jnp.asarray(
        rng.normal(0, 0.3, p.b.shape).astype(np.float32)))
        for p in jp["lstm"]]
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, jcfg, tmodels.model_from_numpy(tree, device="cpu"), tcfg


def _frames(t, b, seed=1):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 0.3, (t, b, 40)), 0).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _leaves(state):
    out = []
    for layer in state.layers:
        out += [layer.h, layer.c, layer.x_mem.memory, layer.h_mem.memory,
                layer.m]
    return out


def _compile(jp, tp, backend):
    return (jprogram.compile_delta_program(jp, backend, cell="lstm"),
            tprogram.compile_delta_program(tp, backend, cell="lstm",
                                           device="cpu"))


def _same_report(jr, tr):
    assert jr.keys() == tr.keys()
    for k in jr:
        if isinstance(jr[k], float) and k not in EXACT_FLOAT_KEYS:
            assert tr[k] == pytest.approx(jr[k], rel=1e-6), k
        else:
            assert jr[k] == tr[k], k


# -- registry and dims ----------------------------------------------------------

def test_registry_lists_the_seven_lstm_backends_in_order():
    assert tbackends.list_backends("lstm") == jbackends.list_backends("lstm")
    assert len(tbackends.list_backends("lstm")) == 7
    for name in tbackends.list_backends("lstm"):
        js = jbackends.get_backend(name, cell="lstm")
        ts = tbackends.get_backend(name, cell="lstm")
        for attr in ("m_init", "weight_bits", "weight_fetch", "cell"):
            assert getattr(js, attr) == getattr(ts, attr), (name, attr)
    assert tlstm.lstm_stack_m_init("fused_q4") == "zero"
    assert tlstm.lstm_stack_m_init("fused") == "bias"


def test_lstm_dims_match_jax():
    for dims in [(40, 768, 2), (14, 256, 2), (8, 128, 1)]:
        jd, td = jsparsity.lstm_dims(*dims), tsparsity.lstm_dims(*dims)
        assert (jd.gates, jd.x_weight_volume, jd.h_weight_volume,
                jd.params_per_timestep_ops) == (
            td.gates, td.x_weight_volume, td.h_weight_volume,
            td.params_per_timestep_ops)
    # 2L-768H: 4 * 768 * (40 + 768) + 4 * 768 * 1536 real weights
    assert tsparsity.lstm_dims(40, 768, 2).n_params == 7_200_768


# -- sequences ------------------------------------------------------------------

@pytest.mark.parametrize("backend", QUANT)
@pytest.mark.parametrize("h", [48, 160])
@pytest.mark.parametrize("theta", [(0.0, 0.0), (0.1, 0.2)])
def test_quant_sequences_bitwise_vs_jax_oracle(backend, h, theta):
    jp, _, tp, _ = _models(h)
    xs = _frames(24, 4)
    jprog, tprog = _compile(jp, tp, backend)
    jy, js, jst = jprog.sequence(jnp.asarray(xs), *theta)
    ty, ts, tst = tprog.sequence(torch.from_numpy(xs), *theta)
    _eq(jy, ty.numpy())
    for a, b in zip(_leaves(js), _leaves(ts)):
        _eq(a, b.numpy())
    # firing statistics are means of exact 0/1 counts: XLA compiles a mean
    # as a sum times the reciprocal of the count, torch divides
    for (jx, jh), (tx, th) in zip(jst["per_layer"], tst["per_layer"]):
        np.testing.assert_allclose(np.asarray(jx), tx.numpy(), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(jh), th.numpy(), rtol=1e-6)


@pytest.mark.parametrize("backend", ["fused_q8", "fused_q4", "fused"])
def test_sequences_vs_jax_pallas_interpret(backend):
    jp, _, tp, _ = _models(160)
    xs = _frames(3, 2, seed=7)
    jprog, tprog = _compile(jp, tp, backend)
    jy, js, _ = jprog.with_interpret(True).sequence(jnp.asarray(xs), 0.1, 0.2)
    ty, ts, _ = tprog.sequence(torch.from_numpy(xs), 0.1, 0.2)
    if backend == "fused":
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                                   atol=TOL_F32)
    else:
        _eq(jy, ty.numpy())
        for a, b in zip(_leaves(js), _leaves(ts)):
            _eq(a, b.numpy())


@pytest.mark.parametrize("backend", FP32)
@pytest.mark.parametrize("h", [48, 160])
def test_fp32_sequences_within_bound_at_theta_zero(backend, h):
    jp, _, tp, _ = _models(h)
    xs = _frames(24, 4)
    jprog, tprog = _compile(jp, tp, backend)
    jy, js, jst = jprog.sequence(jnp.asarray(xs))
    ty, ts, tst = tprog.sequence(torch.from_numpy(xs))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                               atol=TOL_F32)
    for a, b in zip(_leaves(js), _leaves(ts)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=TOL_F32)
    assert float(jst["gamma_dx"]) == float(tst["gamma_dx"]) == 0.0


def _torch_state(jstate, tprog, batch):
    """The port's program state holding the JAX state's values."""
    ts = tprog.init_state((batch,))
    layers = []
    for jl, tl in zip(jstate.layers, ts.layers):
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        layers.append(tl._replace(h=t(jl.h), c=t(jl.c),
                                  x_mem=DeltaState(t(jl.x_mem.memory)),
                                  h_mem=DeltaState(t(jl.h_mem.memory)),
                                  m=t(jl.m)))
    return tprogram.DeltaProgramState(
        stack=tlstm.DeltaLstmStackState(tuple(layers)), backend=ts.backend,
        cell="lstm")


@pytest.mark.parametrize("backend", ["fused", "fused_batch", "dense"])
def test_fp32_lockstep_at_dual_theta(backend):
    jp, _, tp, _ = _models(160)
    xs = _frames(12, 4, seed=3)
    jprog, tprog = _compile(jp, tp, backend)
    js = jprog.init_state((4,))
    for x in xs:
        ts = _torch_state(js, tprog, 4)
        jy, js, _ = jprog.step(js, jnp.asarray(x), 0.1, 0.2)
        ty, ts, _ = tprog.step(ts, torch.from_numpy(x), 0.1, 0.2)
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                                   atol=TOL_F32)
        for a, b in zip(_leaves(js), _leaves(ts)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=TOL_F32)


def test_lstm_oracle_and_theta_zero_identity():
    jp, _, tp, _ = _models(48)
    xs = _frames(16, 3)
    jy = jlstm.lstm_sequence(jp["lstm"], jnp.asarray(xs))
    ty = tlstm.lstm_sequence(tp["lstm"], torch.from_numpy(xs))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                               atol=TOL_F32)
    dy, _, _ = tlstm.deltalstm_sequence(tp["lstm"], torch.from_numpy(xs),
                                        0.0, 0.0)
    np.testing.assert_allclose(dy.numpy(), ty.numpy(), rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("backend", ["fused", "fused_q8", "fused_q4"])
def test_batched_tile_equals_streams_one_at_a_time(backend):
    _, _, tp, _ = _models(48)
    xs = torch.from_numpy(_frames(10, 3, seed=4))
    tile = tprogram.compile_delta_program(tp, backend + "_batch",
                                          cell="lstm", device="cpu")
    solo = tprogram.compile_delta_program(tp, backend, cell="lstm",
                                          device="cpu")
    ty, _, _ = tile.sequence(xs, 0.1, 0.2)
    for s in range(3):
        sy, _, _ = solo.sequence(xs[:, s:s + 1], 0.1, 0.2)
        if backend == "fused":
            np.testing.assert_allclose(ty[:, s].numpy(), sy[:, 0].numpy(),
                                       rtol=0, atol=TOL_F32)
        else:
            _eq(ty[:, s].numpy(), sy[:, 0].numpy())


@pytest.mark.parametrize("backend", ["fused_q8", "fused_q4"])
def test_cell_state_clips_at_the_rail_like_jax(backend):
    # zero weights, biases that drive i = f = g to 1.0 on the Q1.4 LUT:
    # c grows by one a step and must stop at act_max, never wrap
    h, i = 8, 4
    b = np.concatenate([np.full(3 * h, 8.0), np.zeros(h)]).astype(np.float32)
    jp = [jlstm.LstmLayerParams(jnp.zeros((4 * h, i)), jnp.zeros((4 * h, h)),
                                jnp.asarray(b))]
    tp = [tlstm.LstmLayerParams(torch.zeros(4 * h, i), torch.zeros(4 * h, h),
                                torch.from_numpy(b))]
    xs = np.zeros((300, 1, i), np.float32)
    jprog, tprog = _compile(jp, tp, backend)
    _, js, _ = jprog.sequence(jnp.asarray(xs))
    _, ts, _ = tprog.sequence(torch.from_numpy(xs))
    c = ts.layers[0].c.numpy()
    np.testing.assert_array_equal(c, np.full_like(c, tprog.layouts[0].act_max))
    for a, t in zip(_leaves(js), _leaves(ts)):
        _eq(a, t.numpy())


# -- programs, exporter, models -------------------------------------------------

def test_program_carries_the_head_and_refuses_other_cells_states():
    _, _, tp, _ = _models(48)
    lq8 = tprogram.compile_delta_program(tp, "fused_q8", cell="lstm",
                                         device="cpu")
    assert lq8.cell == "lstm" and lq8.head is not None
    _eq(lq8.head.numpy(), tp["head"].numpy())
    assert (lq8.num_layers, lq8.input_size, lq8.hidden_size) == (2, 40, 48)
    assert float(lq8.init_state((2,)).layers[0].m.abs().sum()) == 0.0
    fp = tprogram.compile_delta_program(tp, "fused", cell="lstm",
                                        device="cpu")
    m0 = fp.init_state((2,)).layers[0].m
    _eq(m0[0].numpy(), tp["lstm"][0].b.numpy())       # biases folded into M
    gru_model = tmodels.init_gru_model(0, tmodels.GruTaskConfig(40, 48, 2,
                                                                12),
                                       device="cpu")
    gq8 = tprogram.compile_delta_program(gru_model, "fused_q8", device="cpu")
    with pytest.raises(ValueError, match="built for cell 'gru'"):
        lq8.step(gq8.init_state((1,)), torch.zeros(1, 40))
    with pytest.raises(ValueError, match="built for cell 'lstm'"):
        gq8.step(lq8.init_state((1,)), torch.zeros(1, 40))
    with pytest.raises(ValueError, match="'lstm' stack"):
        tprogram.compile_delta_program(gru_model, cell="lstm", device="cpu")
    assert tprogram.infer_cell(tp) == "lstm"
    assert lq8.with_backend("fused_q8_batch").backend == "fused_q8_batch"


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_delta_model_infers_lstm_and_matches_jax(bits):
    jp, _, tp, _ = _models(160)
    jprog = jexport.quantize_delta_model(jp, bits=bits)
    tprog = texport.quantize_delta_model(tp, bits=bits, device="cpu")
    assert tprog.cell == jprog.cell == "lstm"
    assert tprog.backend == jprog.backend
    for jl, tl in zip(jprog.layers, tprog.layers):
        for a, b in zip(jl, tl):
            _eq(a, b.numpy())
    for jl, tl in zip(jprog.layouts, tprog.layouts):
        _eq(jl.w_q, tl.w_q.numpy())
        _eq(jl.b4, tl.b4.numpy())
    with pytest.raises(ValueError, match="'gru' stack"):
        texport.quantize_gru_model(tp, device="cpu")
    with pytest.raises(ValueError, match="wrong cell family"):
        texport.quantize_delta_stack(tp["lstm"], cell="gru")


def test_init_lstm_model_seeded_shapes_and_device_rule(monkeypatch):
    cfg = tmodels.GruTaskConfig(40, 48, 2, 12)
    a = tmodels.init_lstm_model(3, cfg, device="cpu")
    b = tmodels.init_lstm_model(torch.Generator().manual_seed(3), cfg,
                                device="cpu")
    for x, y in zip([*a["lstm"][1], a["head"]], [*b["lstm"][1], b["head"]]):
        _eq(x.numpy(), y.numpy())
    assert isinstance(a["lstm"][0], tlstm.LstmLayerParams)
    assert a["lstm"][0].w_x.shape == (192, 40)
    assert a["lstm"][1].w_h.shape == (192, 48)
    assert a["head"].shape == (48, 12)
    bias = a["lstm"][0].b.numpy()
    _eq(bias[48:96], np.ones(48, np.float32))         # forget gate
    assert not bias[:48].any() and not bias[96:].any()
    assert float(a["lstm"][0].w_x.abs().max()) <= (6.0 / (40 + 192)) ** 0.5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.init_lstm_model(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprogram.compile_delta_program(a, cell="lstm")


def test_model_from_numpy_carries_an_lstm_dict_bit_for_bit():
    jp, _, tp, _ = _models(48)
    assert isinstance(tp["lstm"][0], tlstm.LstmLayerParams)
    for jl, tl in zip(jp["lstm"], tp["lstm"]):
        for a, b in zip(jl, tl):
            _eq(a, b.numpy())
    _eq(jp["head"], tp["head"].numpy())
    _eq(jp["head_b"], tp["head_b"].numpy())


# -- engine and batcher -------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_engine_fused_q8_matches_jax(n):
    jp, jcfg, tp, tcfg = _models(48, theta=(0.25, 0.25))
    jprog, tprog = _compile(jp, tp, "fused_q8")
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=n)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=n, device="cpu")
    xs = _frames(20, n)
    if n == 1:
        xs = xs[:, 0]
    jo = np.asarray(je.step_many(xs))
    to = te.step_many(xs)
    for a, b in zip(_leaves(je.state), _leaves(te.state)):
        _eq(a, b.numpy())
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=TOL_HEAD)
    _same_report(je.report(), te.report())
    assert te.report()["cell"] == "lstm"
    assert te.report()["backend"] == ("fused_q8" if n == 1
                                      else "fused_q8_batch")


@pytest.mark.parametrize("backend", ["fused", "fused_q4"])
def test_engine_other_backends_match_jax(backend):
    # fp32 at theta=0 (no threshold decision can flip), int4 at 0.25
    theta = (0.0, 0.0) if backend == "fused" else (0.25, 0.25)
    jp, jcfg, tp, tcfg = _models(48, theta=theta)
    jprog, tprog = _compile(jp, tp, backend)
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=3)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=3, device="cpu")
    for x in _frames(12, 3):
        np.testing.assert_allclose(te.step(x).numpy(), np.asarray(je.step(x)),
                                   rtol=0, atol=1e-5)
    _same_report(je.report(), te.report())


def test_batcher_drains_mixed_lengths_like_jax():
    jp, jcfg, tp, tcfg = _models(48, theta=(0.25, 0.25))
    jprog, tprog = _compile(jp, tp, "fused_q8")
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
        np.testing.assert_allclose(np.stack(tr.outputs),
                                   np.stack(jd[uid].outputs), rtol=0,
                                   atol=TOL_HEAD)
        _same_report(jd[uid].stats, tr.stats)
    _same_report(jb.engine.report(), tb.engine.report())


def test_sessions_roll_back_and_guard_the_cell_state():
    _, _, tp, tcfg = _models(48, theta=(0.25, 0.25))
    tprog = tprogram.compile_delta_program(tp, "fused_q8", cell="lstm",
                                           device="cpu")
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=2, device="cpu")
    xs = _frames(12, 2)
    assert te.open_stream() == 0 and te.open_stream() == 1
    te.step_many(xs[:4])
    te.snapshot_streams([1])
    after = te.step_many(xs[4:8])
    c_after = te.state.layers[0].c.clone()
    assert te.rollback_stream(1) == 4
    replay = te.step_many(xs[4:8])
    _eq(replay[:, 1].numpy(), after[:, 1].numpy())
    _eq(te.state.layers[0].c[1].numpy(), c_after[1].numpy())
    # a reopened slot starts from a fresh state, the cell state included
    te.close_stream(0)
    assert te.open_stream() == 0
    fresh = tprog.init_state((2,))
    for a, b in zip(_leaves(te.state), _leaves(fresh)):
        _eq(a[0].numpy(), b[0].numpy())
    # a non-finite cell state is seen by the state guard
    st = te.state
    layer = st.layers[1]._replace(c=st.layers[1].c.clone())
    layer.c[1, 3] = float("nan")
    bad = tprogram.DeltaProgramState(
        stack=tlstm.DeltaLstmStackState((st.layers[0], layer)),
        backend=st.backend, cell="lstm")
    _eq(nonfinite_rows(list(tengine._leaves(bad.stack)), 2, "cpu").numpy(),
        np.array([0.0, 1.0], np.float32))
