"""The port's fixed-buffer ``DeltaStreamEngine`` (the state, carry and frame
live in buffers written in place; on a CUDA device one step over them is a
captured CUDA graph, replayed each step), on the CPU at I=40, H=48, 2
layers, against the JAX package's engine.

Two spellings of the port's engine run every sequence: the CPU's own eager
step, and the replay path driven through a stub of the graph capture
(``_capture``), whose "graph" reruns the step into an output buffer of its
own, as a replay overwrites a CUDA graph's static output. Both are held to
the JAX engine: the recurrent state bitwise for ``fused_q8`` / ``fused_q4``
and within ``TOL_F32`` for ``fused`` (at θ = 0, the bound of
``test_torch_engine.py``); outputs within ``TOL_HEAD`` (the head is one
fp32 matmul whose summation order each library picks); reports key by key
as in ``test_torch_engine.py``. The stub engine must give the eager
engine's bits everywhere. The stub records the engine's buffer pointers at
capture and fails any replay after one moved, as the card's graph would
silently step the old buffer.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.core import program as jprogram
from repro.models import gru_rnn as jmodels
from repro.serve import engine as jengine
from repro.serve import scheduler as jscheduler
from repro_torch.core import program as tprogram
from repro_torch.core.thresholds import ThresholdPolicy
from repro_torch.kernels import ops
from repro_torch.models import gru_rnn as tmodels
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tscheduler

torch.set_num_threads(1)

H, N = 48, 3
TOL_HEAD = 1e-6
TOL_F32 = 1e-5
EXACT_FLOAT_KEYS = ("theta_x", "theta_h", "poison_steps", "bad_state_steps")
# the launches the stub's capture pretends its wrappers counted
STUB_KERNEL, STUB_LAUNCHES = ops.DELTA_Q8_GRU_I8, 2


def _setup(backend, theta, seed=0):
    jcfg = jmodels.GruTaskConfig(40, H, 2, 12, theta_x=theta, theta_h=theta)
    tcfg = tmodels.GruTaskConfig(40, H, 2, 12, theta_x=theta, theta_h=theta)
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


def buffer_ptrs(eng) -> list:
    """The data pointers of the engine's buffers: the live state, carry and
    frame a captured step reads and writes, and the rollback shadows."""
    bufs = (list(tengine._leaves(eng.state.stack)) + list(eng._carry.values())
            + [eng._x] + list(tengine._leaves(eng._snap_state.stack))
            + list(eng._snap_carry.values()))
    return [t.data_ptr() for t in bufs]


def stub_capture(body):
    """A stand-in for ``_capture_cuda_graph`` on the CPU. Capturing runs no
    kernel but calls every wrapper once: here it runs nothing and counts
    ``STUB_LAUNCHES`` of ``STUB_KERNEL``. It records the engine's buffer
    pointers, and every replay fails if one moved: a CUDA graph replays
    over the buffers it captured, so an engine that put a new tensor in a
    buffer's place (rebinding instead of writing in place) would step the
    old one on the card. Its replay reruns the step and copies the output
    into one buffer that every replay overwrites, as a CUDA graph's static
    output is."""
    eng = inspect.getclosurevars(body).nonlocals["self"]
    captured = buffer_ptrs(eng)
    STUB_KERNEL.launches += STUB_LAUNCHES
    static = []

    def replay():
        assert buffer_ptrs(eng) == captured, (
            "an engine buffer was rebound after the capture; the graph "
            "would replay over the old one")
        out = body()
        if not static:
            static.append(torch.empty_like(out))
        static[0].copy_(out)
        return static[0]

    return replay


def _engine(tprog, tcfg, mode, **kw):
    eng = tengine.DeltaStreamEngine(tprog, tcfg, device="cpu", **kw)
    if mode == "stub graph":
        eng._capture = stub_capture
    return eng


def _same_state(je, te, exact):
    for a, b in zip(_leaves(je.state), _leaves(te.state)):
        if exact:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=TOL_F32)


MODES = ["eager", "stub graph"]
# (backend, θ, the Θ_h set_theta_h writes): fp32 at θ = 0, where no
# threshold decision can flip between the libraries
BACKENDS = [("fused_q8", 0.25, 0.3), ("fused_q4", 0.25, 0.3),
            ("fused", 0.0, 0.0)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend,theta,theta_set", BACKENDS)
def test_sessions_interleaved_with_steps_match_jax(backend, theta, theta_set,
                                                   mode):
    jprog, jcfg, tprog, tcfg = _setup(backend, theta)
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=N)
    te = _engine(tprog, tcfg, mode, n_streams=N)
    xs = _frames(40, N)
    exact = backend != "fused"
    held = []

    def both(call, *args):
        jr, tr = getattr(je, call)(*args), getattr(te, call)(*args)
        if call in ("step", "step_many"):
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                       atol=TOL_HEAD)
            held.append((tr, tr.clone()))
        elif call == "close_stream":
            _same_report(jr, tr)
        else:
            assert jr == tr, call
        _same_state(je, te, exact)

    both("open_stream")
    both("open_stream")
    both("step_many", xs[:4])
    both("snapshot_streams", [1])
    both("step", xs[4])
    both("set_theta_h", theta_set)
    both("step_many", xs[5:9])
    both("rollback_stream", 1)
    both("step_many", xs[9:12])
    both("close_stream", 0)
    both("open_stream")
    both("step", xs[12])
    both("snapshot_streams")
    both("step_many", xs[13:16])
    both("rollback_stream", 0)
    both("open_stream")
    both("step_many", xs[16:20])
    assert te.theta_h == je.theta_h == pytest.approx(theta_set)
    _same_report(je.report(), te.report())
    both("reset")
    assert te.theta_h == je.theta_h == theta
    both("open_stream")
    both("step_many", xs[20:26])
    both("close_stream", 0)
    _same_report(je.report(), te.report())
    # every result handed out earlier is its own tensor: untouched since
    for out, copy in held:
        assert torch.equal(out, copy)
    if mode == "stub graph":
        assert te.graph_stats["captures"] == 1
        assert te.graph_stats["replays"] == 26


@pytest.mark.parametrize("mode", MODES)
def test_graph_steps_equal_eager_steps_bitwise(mode):
    # the replay path against the CPU's eager step: every output and the
    # whole state, bit for bit, through sessions and a Θ_h controller
    _, _, tprog, tcfg = _setup("fused", 0.1)
    eager = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=N, device="cpu",
                                      dynamic_target_fired=0.2)
    te = _engine(tprog, tcfg, mode, n_streams=N, dynamic_target_fired=0.2)
    xs = _frames(12, N, seed=3)
    for eng in (eager, te):
        eng.open_stream()
    np.testing.assert_array_equal(te.step_many(xs[:6]).numpy(),
                                  eager.step_many(xs[:6]).numpy())
    for x in xs[6:]:
        np.testing.assert_array_equal(te.step(x).numpy(),
                                      eager.step(x).numpy())
    for a, b in zip(_leaves(eager.state), _leaves(te.state)):
        assert torch.equal(a, b)
    for k in eager._carry:
        assert torch.equal(eager._carry[k], te._carry[k]), k
    assert te.report() == eager.report()
    assert te.theta_h != 0.1                       # the controller moved


def test_a_held_result_survives_later_replays():
    # the stub overwrites one output buffer each replay, as a CUDA graph
    # does: step and step_many hand out copies
    _, _, tprog, tcfg = _setup("fused_q8", 0.25)
    te = _engine(tprog, tcfg, "stub graph")
    xs = _frames(10, 1)[:, 0]
    first = te.step(xs[0])
    first_copy = first.clone()
    chunk = te.step_many(xs[1:5])
    chunk_copy = chunk.clone()
    te.step(xs[5])
    te.step_many(xs[6:])
    assert torch.equal(first, first_copy)
    assert torch.equal(chunk, chunk_copy)
    assert not torch.equal(chunk[0], chunk[-1])


@pytest.mark.parametrize("mode", MODES)
def test_batcher_with_sessions_between_replays_matches_jax(mode):
    jprog, jcfg, tprog, tcfg = _setup("fused_q8", 0.25)
    jb = jscheduler.GruStreamBatcher(
        jengine.DeltaStreamEngine(jprog, jcfg, n_streams=4))
    tb = tscheduler.GruStreamBatcher(_engine(tprog, tcfg, mode, n_streams=4))
    rng = np.random.default_rng(7)
    for i, t in enumerate(rng.integers(3, 15, 9)):
        fr = _frames(int(t), 1, seed=20 + i)[:, 0]
        assert jb.submit(fr) == tb.submit(fr)
    jd = {r.uid: r for r in jb.run_until_drained()}
    td = {r.uid: r for r in tb.run_until_drained()}
    assert jd.keys() == td.keys() and len(td) == 9
    for uid, tr in td.items():
        np.testing.assert_allclose(np.stack(tr.outputs),
                                   np.stack(jd[uid].outputs), rtol=0,
                                   atol=TOL_HEAD)
        _same_report(jd[uid].stats, tr.stats)
    _same_report(jb.engine.report(), tb.engine.report())
    _same_state(jb.engine, tb.engine, exact=True)


def _storages(tensors):
    return [t.untyped_storage().data_ptr() for t in tensors]


def test_reset_gives_every_buffer_a_tensor_of_its_own():
    # a buffer shared by two keys would make their in-place updates one
    _, _, tprog, tcfg = _setup("fused_q8", 0.25)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=N, device="cpu")
    for _ in range(2):
        live = list(tengine._leaves(te.state.stack)) + list(
            te._carry.values())
        snap = list(tengine._leaves(te._snap_state.stack)) + list(
            te._snap_carry.values())
        ptrs = _storages(live + snap)
        assert len(set(ptrs)) == len(ptrs)
        per_stream = _storages(te._carry[k] for k in te._PER_STREAM_KEYS)
        assert len(set(per_stream)) == 6
        te.step(_frames(1, N)[0])
        te.reset()
    # the six accumulators move apart: a frame with a NaN counts a poison
    # step in poison_steps alone
    x = _frames(1, N)[0]
    x[1, 3] = np.nan
    te.step(x)
    host = te.host_carry()
    assert host["poison_steps"].tolist() == [0.0, 1.0, 0.0]
    assert host["bad_state"].tolist() == [0.0, 0.0, 0.0]
    assert host["fired_x"][0] > 0 and host["lat_s"][0] > 0
    # the rollback shadow is a copy, not the live state
    before = [t.clone() for t in tengine._leaves(te._snap_state.stack)]
    te.step(_frames(2, N, seed=4)[1])
    for a, b in zip(before, tengine._leaves(te._snap_state.stack)):
        assert torch.equal(a, b)


def test_the_capture_key():
    _, _, tprog, tcfg = _setup("fused_q8", 0.25)
    te = tengine.DeltaStreamEngine(tprog, tcfg, device="cpu")
    key = te._capture_key()
    assert te._capture_key() == key                 # a pure function
    te.set_theta_h(0.5)                             # a buffer: stays live
    te.reset()
    assert te._capture_key() == key
    te.theta_x = 0.3
    assert te._capture_key() != key
    te.theta_x = 0.25
    assert te._capture_key() == key
    te.program = tprog.with_backend("fused_q8")     # the same object
    assert te._capture_key() == key
    te.program = tprogram.compile_deltagru(
        {"gru": tprog.layers, "head": tprog.head, "head_b": tprog.head_b},
        "fused_q8", device="cpu")
    assert te._capture_key() != key
    layered = tengine.DeltaStreamEngine(
        tprog, tcfg, device="cpu",
        thresholds=ThresholdPolicy(0.1, 0.2, per_layer_x=(0.05,)))
    other = tengine.DeltaStreamEngine(
        tprog, tcfg, device="cpu",
        thresholds=ThresholdPolicy(0.1, 0.2, per_layer_x=(0.06,)))
    assert layered._capture_key() != other._capture_key()
    dyn = tengine.DeltaStreamEngine(tprog, tcfg, device="cpu",
                                    dynamic_target_fired=0.2)
    assert dyn._capture_key() != key


def test_a_changed_key_recaptures_and_steps_as_eager():
    _, _, tprog, tcfg = _setup("fused_q8", 0.25)
    eager = tengine.DeltaStreamEngine(tprog, tcfg, device="cpu")
    te = _engine(tprog, tcfg, "stub graph")
    xs = _frames(8, 1)[:, 0]
    for eng in (eager, te):
        eng.step_many(xs[:3])
        eng.theta_x = 0.5
        eng.step_many(xs[3:])
    assert te.graph_stats["captures"] == 2 and te.graph_stats["replays"] == 8
    for a, b in zip(_leaves(eager.state), _leaves(te.state)):
        assert torch.equal(a, b)
    assert te.report() == eager.report()


def test_launch_accounting_with_a_stub_graph():
    # the capture's counts are taken back; each replay adds them once
    _, _, tprog, tcfg = _setup("fused_q8", 0.25)
    te = _engine(tprog, tcfg, "stub graph")
    xs = _frames(8, 1)[:, 0]
    ops.reset_launch_counts()
    te.step(xs[0])                                  # capture, then a replay
    assert ops.launch_counts()[STUB_KERNEL.name] == STUB_LAUNCHES
    te.step_many(xs[1:5])
    assert ops.launch_counts()[STUB_KERNEL.name] == 5 * STUB_LAUNCHES
    te.theta_x = 0.3                                # recapture, taken back
    te.step(xs[5])
    counts = ops.launch_counts()
    assert counts[STUB_KERNEL.name] == 6 * STUB_LAUNCHES
    assert sum(counts.values()) == counts[STUB_KERNEL.name]
    assert te.graph_stats == {"captures": 2, "replays": 6,
                              "capture_s": te.graph_stats["capture_s"]}
    ops.reset_launch_counts()


def test_take_back_and_add_launches():
    ops.reset_launch_counts()
    ops.RWKV6_SCAN_F32.launches = 5
    before = ops.launch_counts()
    ops.RWKV6_SCAN_F32.launches += 24
    ops.DELTA_SPMV_F32.launches += 96
    counted = ops.take_back_launches(before)
    assert ops.launch_counts() == before
    assert dict((k.name, n) for k, n in counted) == {
        ops.DELTA_SPMV_F32.name: 96, ops.RWKV6_SCAN_F32.name: 24}
    for _ in range(3):
        ops.add_launches(counted)
    assert ops.RWKV6_SCAN_F32.launches == 5 + 3 * 24
    assert ops.DELTA_SPMV_F32.launches == 3 * 96
    assert ops.take_back_launches(ops.launch_counts()) == ()
    ops.reset_launch_counts()


def test_cpu_engines_step_eagerly():
    _, _, tprog, tcfg = _setup("fused", 0.0)
    te = tengine.DeltaStreamEngine(tprog, tcfg, device="cpu")
    assert te._capture is None
    te.step_many(_frames(3, 1)[:, 0])
    assert te.graph_stats == {"captures": 0, "capture_s": 0.0, "replays": 0}
