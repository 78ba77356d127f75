"""The serving paths' captured programs, on the CPU, against the JAX
package: ``DeltaStreamEngine``'s session programs (an open is one fill of
the slot buffer and one replay of the reference's jitted ``_reset_streams``
and ``_merge_rows``; snapshot and rollback one replay of the merge; the
fleet's open the reset alone) and ``LmEngine``'s decode step (one replay
over the caches and the token buffer, the reference's jitted decode).

The port's engines run their programs through a stub of the graph capture:
``test_torch_engine_graph.py``'s ``stub_capture`` for the stream engine,
which records the buffer pointers at capture and fails a replay after one
moved, and ``lm_stub`` here for the LM engine, which does the same over
the caches and the token buffer. Both rerun the captured body at a replay,
into an output that every replay overwrites, as a CUDA graph's static
output is. ``session_stub`` also holds the session programs' own buffers
(the slot, the row mask and the fresh rows) in place.

Held: the stub-graph port bitwise the port's eager run everywhere (state,
carry, rollback shadows, outputs, logits); the port against JAX as the
other ``test_torch_*`` files hold it: the int8/int4 state and shadows
bitwise, fp32 within ``TOL_F32`` of the leaf's largest magnitude or of 1
(θ = 0, where no threshold decision can flip between the libraries),
outputs within ``TOL_HEAD`` (the LM cells within ``TOL_F32``, as
``test_torch_deltarwkv.py`` holds them), reports key by key (counts and θ
exactly, the fp32 accounting within 1e-6 relative), the LM logits within
``TOL_LM`` of their magnitude (``test_torch_lm.py``'s bound), tokens under
``test_torch_lm_serve.py``'s margin rule.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.program import compile_delta_program as jcompile
from repro.dist.elastic import best_mesh as jbest_mesh
from repro.dist.serving import ShardedStreamFleet as JFleet
from repro.models import gru_rnn as jmodels
from repro.quant.export import quantize_delta_model as jquant
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.core import program as tprogram
from repro_torch.core.program import compile_delta_program as tcompile
from repro_torch.dist import serving as tserving
from repro_torch.dist.elastic import best_mesh
from repro_torch.models import gru_rnn as tmodels
from repro_torch.models.common import tree_leaves
from repro_torch.quant.export import quantize_delta_model as tquant
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from test_torch_engine_graph import stub_capture
from test_torch_lm_serve import (_drive, _flip_tol, _margin, _model,
                                 _modality, _recording, _same_tokens)

torch.set_num_threads(1)

N = 3
TOL_HEAD = 1e-6
TOL_F32 = 1e-5
TOL_LM = 2e-5
EXACT_FLOAT_KEYS = ("theta_x", "theta_h", "poison_steps", "bad_state_steps")
# (cell, backend, θ): the eight cells of the engine
CELLS = [("gru", "fused", 0.0), ("gru", "fused_q8", 0.25),
         ("gru", "fused_q4", 0.25), ("lstm", "fused", 0.0),
         ("lstm", "fused_q8", 0.25), ("lstm", "fused_q4", 0.25),
         ("rwkv6", "fused", 0.0), ("rglru", "fused", 0.0)]
# a dense, a MoE, an MLA (with MoE), a cross-attention and an RWKV6 config
LM_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
            "llama-3.2-vision-11b", "rwkv6-1.6b")


# -- the stream engine's session programs -------------------------------------

def session_stub(body):
    """``stub_capture``, and every replay also fails if the slot buffer,
    the row mask or (for a graph captured after they were built) the fresh
    rows were put in another tensor's place."""
    eng = inspect.getclosurevars(body).nonlocals["self"]
    fresh = eng._fresh
    held = (eng._slot.data_ptr(), eng._rows.data_ptr())
    replay = stub_capture(body)

    def checked():
        assert (eng._slot.data_ptr(), eng._rows.data_ptr()) == held
        assert fresh is None or eng._fresh is fresh, (
            "the fresh rows were rebuilt under a live graph")
        return replay()

    return checked


def _cell(cell, backend, theta, seed=3):
    """The same JAX-made weights compiled by both packages, and both
    tasks. GRU / LSTM: I = 12, H = 16, 2 layers; the LM cells D = 64, 2
    layers."""
    key = jax.random.PRNGKey(seed)
    if cell in ("gru", "lstm"):
        dims = (12, 16, 2, 5)
        jtask = jmodels.GruTaskConfig(*dims, theta_x=theta, theta_h=theta)
        init = (jmodels.init_gru_model if cell == "gru"
                else jmodels.init_lstm_model)
        jm = init(key, jtask)
    else:
        from repro.core.deltarglru import init_deltarglru_model
        from repro.core.deltarwkv import init_deltarwkv_model
        dims = (64, 64, 2, 5)
        jtask = jmodels.GruTaskConfig(*dims, theta_x=theta, theta_h=theta)
        init = (init_deltarwkv_model if cell == "rwkv6"
                else init_deltarglru_model)
        jm = init(key, 64, 2, 5)
    tm = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jm),
                                  device="cpu")
    ttask = tmodels.GruTaskConfig(*dims, theta_x=theta, theta_h=theta)
    if backend in ("fused_q8", "fused_q4"):
        bits = 8 if backend == "fused_q8" else 4
        return (jquant(jm, bits=bits), jtask,
                tquant(tm, bits=bits, device="cpu"), ttask)
    return (jcompile(jm, backend, cell=cell), jtask,
            tcompile(tm, backend, cell=cell, device="cpu"), ttask)


def _stub_engine(tprog, ttask, **kw):
    """The port's engine as on the card: its step captured at
    construction, every program replayed through the stub."""
    eng = tengine.DeltaStreamEngine(tprog, ttask, device="cpu", **kw)
    eng._capture = session_stub
    eng._capture_step()
    return eng


def _frames(t, n, width, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 0.3, (t, n, width)), 0).astype(np.float32)


def _bufs(eng) -> list:
    """Every value the session programs read or write: state, carry and
    their rollback shadows, the carry in sorted key order."""
    return (list(tengine._leaves(eng.state.stack))
            + [eng._carry[k] for k in sorted(eng._carry)]
            + list(tengine._leaves(eng._snap_state.stack))
            + [eng._snap_carry[k] for k in sorted(eng._snap_carry)])


def _jax_bufs(je) -> list:
    return [np.asarray(a) for a in (
        jax.tree_util.tree_leaves(je.state.stack)
        + [je._carry[k] for k in sorted(je._carry)]
        + jax.tree_util.tree_leaves(je._snap_state.stack)
        + [je._snap_carry[k] for k in sorted(je._snap_carry)])]


# the carry's counts, Θ_h and the guard's frame, held exactly against JAX
COUNT_KEYS = ("poison_steps", "bad_state", "agg_poison_steps",
              "agg_bad_state", "theta_h", "last_x")


def _same_report(jr, tr):
    assert jr.keys() == tr.keys()
    for k in jr:
        if isinstance(jr[k], float) and k not in EXACT_FLOAT_KEYS:
            assert tr[k] == pytest.approx(jr[k], rel=1e-6), k
        else:
            assert jr[k] == tr[k], k


@pytest.mark.parametrize("cell,backend,theta", CELLS)
def test_sessions_through_the_programs_match_jax(cell, backend, theta):
    """(a) Opens, steps, snapshots, rollbacks and closes, in lockstep on
    the JAX engine, the port's eager engine and the port's stub-graph
    engine: after every call the stub engine's state, carry and shadows
    bitwise the eager one's; the port's state and shadows bitwise JAX's
    (int8 / int4) or within ``TOL_F32`` (fp32), its counts, Θ_h and
    ``last_x`` exactly and its fp32 accounting within 1e-6 relative."""
    jprog, jtask, tprog, ttask = _cell(cell, backend, theta)
    je = jengine.DeltaStreamEngine(jprog, jtask, n_streams=N)
    eager = tengine.DeltaStreamEngine(tprog, ttask, n_streams=N,
                                      device="cpu")
    graph = _stub_engine(tprog, ttask, n_streams=N)
    xs = _frames(20, N, ttask.input_size, seed=5)
    exact = backend != "fused"
    # the LM cells' outputs as test_torch_deltarwkv.py / deltarglru.py
    # hold them (their dense sides sum in other orders)
    tol_out = TOL_HEAD if cell in ("gru", "lstm") else TOL_F32
    n_state = len(jax.tree_util.tree_leaves(je.state.stack))
    n_carry = len(je._carry)

    def call(name, *args):
        jr = getattr(je, name)(*args)
        er, gr = (getattr(e, name)(*args) for e in (eager, graph))
        if name in ("step", "step_many"):
            assert torch.equal(er, gr)
            np.testing.assert_allclose(gr.numpy(), np.asarray(jr), rtol=0,
                                       atol=tol_out)
        elif name == "close_stream":
            assert er == gr
            _same_report(jr, gr)
        else:
            assert jr == er == gr, name
        for a, b in zip(_bufs(eager), _bufs(graph)):
            assert a.numpy().tobytes() == b.numpy().tobytes(), name
        want = _jax_bufs(je)
        got = [t.numpy() for t in _bufs(graph)]
        keys = sorted(je._carry)
        assert keys == sorted(graph._carry)
        assert len(got) == len(want) == 2 * (n_state + n_carry)
        for i, (g, w) in enumerate(zip(got, want)):
            j = i % (n_state + n_carry)           # live, then the shadow
            if j < n_state and not exact:            # scaled, as TOL_LM
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=TOL_F32 * max(1.0, np.abs(w).max()))
            elif j < n_state or keys[j - n_state] in COUNT_KEYS:
                np.testing.assert_array_equal(g, w)
            else:                                 # the fp32 Eq. 7 terms
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)

    call("open_stream")
    call("open_stream")
    call("step_many", xs[:4])
    call("snapshot_streams", [1])
    call("step", xs[4])
    call("rollback_stream", 1)
    call("step_many", xs[5:8])
    call("close_stream", 0)
    call("open_stream")                # reuses slot 0: reset and shadow
    call("step", xs[8])
    call("snapshot_streams")
    call("step_many", xs[9:12])
    call("rollback_stream", 0)
    call("open_stream")
    call("step_many", xs[12:16])
    call("close_stream", 1)
    call("close_stream", 2)
    call("open_stream")
    call("rollback_stream", 1)         # rewinds to the fresh session state
    call("step_many", xs[16:20])
    _same_report(je.report(), graph.report())
    # each of the four programs captured once, every session call a replay
    assert graph.session_stats["captures"] == 3
    assert graph.session_stats["replays"] == 5 + 2 + 3
    assert sorted(graph._sessions) == ["open", "rollback", "snapshot"]
    assert eager.session_stats == {"captures": 0, "capture_s": 0.0,
                                   "replays": 0}


@pytest.mark.parametrize("cell,backend,theta", CELLS)
def test_an_open_writes_the_rows_of_init_state(cell, backend, theta):
    """(b) The one-slot fresh state broadcast by the reset is, row for row,
    the program's ``init_state((N,))``, under every cell's ``m_init``
    convention: a slot opened after steps holds those rows bitwise, its
    shadow too, and its per-stream accounting is zero."""
    _, _, tprog, ttask = _cell(cell, backend, theta)
    eng = _stub_engine(tprog, ttask, n_streams=N)
    for _ in range(N):
        eng.open_stream()
    eng.step_many(_frames(3, N, ttask.input_size, seed=7))
    eng.close_stream(1)
    assert eng.open_stream() == 1
    want = tengine._leaves(tprog.with_backend(eng.backend).init_state(
        (N,)).stack)
    for live, snap, w in zip(tengine._leaves(eng.state.stack),
                             tengine._leaves(eng._snap_state.stack), want):
        assert live[1].numpy().tobytes() == w[1].numpy().tobytes()
        assert snap[1].numpy().tobytes() == w[1].numpy().tobytes()
    host = eng.host_carry()
    for k in tengine.DeltaStreamEngine._PER_STREAM_KEYS:
        assert host[k][1] == 0.0
    assert not eng._carry["last_x"][1].any()


def test_the_fresh_state_is_built_once_per_program(monkeypatch):
    """(b) ``init_state`` runs once for the opens of one program, not once
    an open; a program swap (a new capture key) builds the new program's
    fresh rows and recaptures the session programs."""
    calls = []
    orig = tprogram.DeltaProgram.init_state

    def counted(self, batch_shape=(), dtype=None):
        calls.append(tuple(batch_shape))
        return orig(self, batch_shape, dtype)

    monkeypatch.setattr(tprogram.DeltaProgram, "init_state", counted)
    _, _, tprog, ttask = _cell("gru", "fused", 0.0)
    eng = _stub_engine(tprog, ttask, n_streams=N)
    assert calls == [(N,)]                          # the engine's reset
    for _ in range(2):
        for _ in range(N):
            eng.open_stream()
        eng.step(_frames(1, N, ttask.input_size, seed=2)[0])
        for sid in range(N):
            eng.close_stream(sid)
    assert calls == [(N,), (1,)]
    assert eng.session_stats["captures"] == 1
    # another program of the same shapes, other weights and biases (the
    # fresh m of the "bias" convention holds them)
    model = tmodels.model_from_numpy(jax.tree_util.tree_map(
        np.asarray, jmodels.init_gru_model(
            jax.random.PRNGKey(9), jmodels.GruTaskConfig(12, 16, 2, 5))),
        device="cpu")
    for layer in model["gru"]:
        layer.b.copy_(torch.linspace(-1.0, 1.0, layer.b.numel()))
    other = tcompile(model, "fused", cell="gru",
                     device="cpu").with_backend(eng.backend)
    eng.program = other
    sid = eng.open_stream()
    assert calls == [(N,), (1,), (1,)]
    assert eng.session_stats["captures"] == 2
    for live, w in zip(tengine._leaves(eng.state.stack),
                       tengine._leaves(other.init_state((N,)).stack)):
        assert live[sid].numpy().tobytes() == w[sid].numpy().tobytes()
    old = tprog.with_backend(eng.backend).init_state((1,))
    assert not torch.equal(eng.state.stack.layers[0].m[sid],
                           old.stack.layers[0].m[0])


def test_a_changed_key_recaptures_the_session_programs():
    _, _, tprog, ttask = _cell("gru", "fused_q8", 0.25)
    eager = tengine.DeltaStreamEngine(tprog, ttask, n_streams=N,
                                      device="cpu")
    graph = _stub_engine(tprog, ttask, n_streams=N)
    xs = _frames(6, N, ttask.input_size, seed=4)
    for eng in (eager, graph):
        eng.open_stream()
        eng.step_many(xs[:3])
        eng.snapshot_streams()
        eng.theta_x = 0.5
        eng.open_stream()
        eng.step_many(xs[3:])
        eng.rollback_stream(0)
    for a, b in zip(_bufs(eager), _bufs(graph)):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    # open and snapshot, then (the key changed) open again and rollback
    assert graph.session_stats["captures"] == 4
    assert graph.session_stats["replays"] == 4
    assert sorted(graph._sessions) == ["open", "rollback"]


def test_session_programs_count_no_launches():
    """A session program launches no counted kernel: opens, snapshots and
    rollbacks leave the launch counts as the steps left them."""
    from repro_torch.kernels import ops
    _, _, tprog, ttask = _cell("gru", "fused_q8", 0.25)
    graph = _stub_engine(tprog, ttask, n_streams=N)
    ops.reset_launch_counts()
    graph.open_stream()
    graph.snapshot_streams()
    graph.rollback_stream(0)
    assert sum(ops.launch_counts().values()) == 0
    assert all(n == () for _, n in graph._sessions.values())
    ops.reset_launch_counts()


def test_the_fleet_open_is_a_reset_alone():
    """(c) The fleet's open resets the slot and leaves the shard's shadow
    as it was, as the JAX fleet's open (which keeps no shadow) does: the
    fleet's state and accounting equal JAX's through the opens, and the
    shard engines replay the reset program, never the open's snapshot."""
    jprog, jtask, tprog, ttask = _cell("gru", "fused_q8", 0.25)
    jf = JFleet(jprog, jtask, n_streams=4, mesh=jbest_mesh(2))
    tf = tserving.ShardedStreamFleet(
        tprog, ttask, n_streams=4,
        mesh=best_mesh(2, devices=[torch.device("cpu")] * 2))
    for eng in tf.engines:
        eng._capture = session_stub
        eng._capture_step()
    xs = _frames(8, 4, ttask.input_size, seed=11)
    for s in (0, 1, 0):
        assert jf.open_stream(s) == tf.open_stream(s)
    for x in xs[:4]:
        np.testing.assert_allclose(tf.step(x).numpy(),
                                   np.asarray(jf.step(x)), rtol=0,
                                   atol=TOL_HEAD)
    shard = tf.engines[0]
    shadow = [t.clone() for t in _bufs(shard)[len(_bufs(shard)) // 2:]]
    host = tf.host_carry()
    jf.close_stream(1, host_carry=jax.device_get(jf._carry))
    tf.close_stream(1, host_carry=host)
    assert jf.open_stream(0) == tf.open_stream(0) == 1
    for a, b in zip(shadow, _bufs(shard)[len(_bufs(shard)) // 2:]):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for x in xs[4:]:
        np.testing.assert_allclose(tf.step(x).numpy(),
                                   np.asarray(jf.step(x)), rtol=0,
                                   atol=TOL_HEAD)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jf.state.stack)]
    got = [torch.cat([list(tengine._leaves(e.state.stack))[i]
                      for e in tf.engines])
           for i in range(len(want))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    jhost, thost = jax.device_get(jf._carry), tf.host_carry()
    for k in ("fired_x", "fired_h", "poison_steps", "bad_state"):
        np.testing.assert_array_equal(thost[k], np.asarray(jhost[k]))
    assert [sorted(e._sessions) for e in tf.engines] == [["reset"],
                                                         ["reset"]]
    assert sum(e.session_stats["replays"] for e in tf.engines) == 4


# -- the LM engine's decode step -------------------------------------------

def lm_stub(body, pool=None, stream=None):
    """A stand-in for ``ops.capture_cuda_graph`` for ``LmEngine``: it records
    the pointers of the caches and the token buffer, and every replay fails
    if one moved (a CUDA graph would decode the old buffers); a replay
    reruns the decode and copies its logits into one tensor that every
    replay overwrites, as a graph's static output is. ``pool`` and
    ``stream`` (a prefill capture's) have no meaning on the CPU."""
    eng = inspect.getclosurevars(body).nonlocals["self"]

    def ptrs():
        return [t.data_ptr() for t in tree_leaves(eng._caches)] + [
            eng._tokens.data_ptr()]

    held, static = ptrs(), []

    def replay():
        assert ptrs() == held, ("a cache or the token buffer was rebound "
                                "after the capture")
        out = body()
        if not static:
            static.append(torch.empty_like(out))
        static[0].copy_(out)
        return static[0]

    return replay


def _lm_engine(tp, tcfg, batch, max_len, stub):
    eng = tengine.LmEngine(tp, tcfg, batch=batch, max_len=max_len,
                           device="cpu")
    if stub:
        eng._capture = lm_stub
    return eng


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_graph_matches_jax_and_the_eager_port(arch):
    """(d) JAX's greedy run, and the port's eager and stub-graph engines
    fed JAX's tokens: the stub's logits bitwise the eager port's at every
    step, within ``TOL_LM`` of JAX's; the stub's own greedy tokens those of
    the eager port, and JAX's up to its first near-tie; one capture, a
    replay a step."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.random.default_rng(3).integers(1, jcfg.vocab, (2, 5)).astype(
        np.int32)
    steps = 4
    mod = _modality(jcfg)
    jeng = jengine.LmEngine(jp, jcfg, batch=2, max_len=32)
    lg = jeng.prefill(jnp.asarray(toks),
                      **{k: jnp.asarray(v) for k, v in mod.items()})
    jlog, jtok = [lg], []
    cur = jnp.argmax(lg[:, -1:], axis=-1)
    for _ in range(steps):
        jtok.append(np.asarray(cur))
        lg = jeng.decode_step(cur)
        jlog.append(lg)
        cur = jnp.argmax(lg[:, -1:], axis=-1)
    want = np.concatenate(jtok, axis=1)
    eager = _lm_engine(tp, tcfg, 2, 32, stub=False)
    graph = _lm_engine(tp, tcfg, 2, 32, stub=True)
    for eng in (eager, graph):
        eng.prefill(toks, **mod)
    for i in range(steps):
        e = eager.decode_step(want[:, i:i + 1])
        g = graph.decode_step(want[:, i:i + 1])
        assert torch.equal(e, g)
        w = np.asarray(jlog[i + 1], np.float32)
        err = np.abs(g.float().numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= TOL_LM
    for a, b in zip(tree_leaves(eager.caches), tree_leaves(graph.caches)):
        assert torch.equal(a, b)
    assert graph.decode_stats["captures"] == 1
    assert graph.decode_stats["replays"] == steps
    # the stub engine's own greedy run
    e_new = _lm_engine(tp, tcfg, 2, 32, stub=False).generate_greedy(
        toks, steps, **mod)
    g_new = _lm_engine(tp, tcfg, 2, 32, stub=True).generate_greedy(
        toks, steps, **mod)
    assert torch.equal(e_new, g_new)
    tol = max(_flip_tol(w) for w in jlog)
    margins = np.stack([_margin(w) for w in jlog[:steps]], axis=1)
    for row in range(2):
        _same_tokens(g_new[row].tolist(), want[row].tolist(), margins[row],
                     tol)


@pytest.mark.parametrize("arch", ("llama3.2-1b", "deepseek-v2-lite-16b"))
def test_the_batcher_keeps_the_cache_buffers(arch):
    """(e) A ``ContinuousBatcher`` over the stub-graph engine, its
    admissions staggered into a partly occupied batch: every cache leaf
    keeps its buffer (the stub fails a replay otherwise), its events and
    tokens are the eager port's exactly and JAX's under the margin rule."""
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, jcfg.vocab, int(n)).tolist()
               for n in rng.integers(2, 8, 6)]
    budgets = [int(n) for n in rng.integers(2, 6, 6)]
    jcb = jsched.ContinuousBatcher(jengine.LmEngine(jp, jcfg, batch=3,
                                                    max_len=48))
    margins, tols = {i: [] for i in range(6)}, []
    _recording(jcb, margins, tols)
    jev, jout = _drive(jcb, prompts, budgets)
    graph = _lm_engine(tp, tcfg, 3, 48, stub=True)
    ptrs = [t.data_ptr() for t in tree_leaves(graph.caches)]
    gev, gout = _drive(tsched.ContinuousBatcher(graph), prompts, budgets)
    eev, eout = _drive(tsched.ContinuousBatcher(
        _lm_engine(tp, tcfg, 3, 48, stub=False)), prompts, budgets)
    assert [t.data_ptr() for t in tree_leaves(graph.caches)] == ptrs
    assert graph.decode_stats["captures"] == 1
    assert gev == eev == jev and gout == eout
    for uid, want in jout.items():
        assert len(gout[uid]) == budgets[uid]
        _same_tokens(gout[uid], want, margins[uid], max(tols))


def test_returned_logits_are_not_overwritten():
    """(f) The graph's logits buffer is overwritten by every replay; each
    ``decode_step`` hands out a copy, as JAX returns an immutable array."""
    _, tcfg, _, tp = _model("llama3.2-1b")
    eng = _lm_engine(tp, tcfg, 2, 32, stub=True)
    eng.prefill(np.array([[1, 2, 3], [4, 5, 6]], np.int32))
    first = eng.decode_step(np.array([[7], [8]], np.int32))
    kept = first.clone()
    second = eng.decode_step(torch.tensor([[9], [10]]))
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr()


def test_caches_assignment_copies_into_the_buffers():
    """Assigning ``caches`` (the JAX engine's style) writes the values into
    the engine's buffers, leaf by leaf; a tree of other shapes or dtypes is
    refused; a changed parameter tree recaptures; a wrong token shape is
    refused."""
    from repro_torch.models.lm import init_lm_caches
    _, tcfg, _, tp = _model("llama3.2-1b")
    eng = _lm_engine(tp, tcfg, 2, 32, stub=True)
    ptrs = [t.data_ptr() for t in tree_leaves(eng.caches)]
    new = init_lm_caches(tcfg, 2, 32, "cpu")
    for t in tree_leaves(new):
        t.fill_(3)
    eng.caches = new
    assert [t.data_ptr() for t in tree_leaves(eng.caches)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(eng.caches),
                                                 tree_leaves(new)))
    with pytest.raises(ValueError, match="shape or dtype"):
        eng.caches = init_lm_caches(tcfg, 2, 16, "cpu")
    with pytest.raises(ValueError, match="one token a slot"):
        eng.decode_step(np.zeros((2, 2), np.int32))
    eng.decode_step(np.zeros((2, 1), np.int32))
    eng.params = dict(tp)                            # a new tree
    eng.decode_step(np.zeros((2, 1), np.int32))
    assert eng.decode_stats["captures"] == 2
    assert eng.decode_stats["replays"] == 2


def test_the_eager_engines_capture_nothing():
    _, tcfg, _, tp = _model("llama3.2-1b")
    eng = _lm_engine(tp, tcfg, 2, 32, stub=False)
    eng.prefill(np.array([[1, 2, 3], [4, 5, 6]], np.int32))
    eng.decode_step(np.array([[7], [8]], np.int32))
    assert eng._capture is None
    assert eng.decode_stats == {"captures": 0, "capture_s": 0.0,
                                "replays": 0}
