"""The port's serving fabric (``dist/elastic.py``, ``dist/serving.py``,
``serve/router.py``, ``serve/loadgen.py``) against the JAX package's, on
the CPU, at the JAX tests' size (I=8, H=16, 2 layers, 3 outputs): every
class of ``tests/test_fabric.py``, each run through both packages on the
same numpy inputs and JAX-made weights, and ``BENCH_fabric.json``'s
tick-exact counts reproduced by the port.

The port's meshes list the CPU once a shard (``devices=[cpu] * n``), the
counterpart of the conftest's 8 forced host devices. Its shard engines are
the fixed-buffer engine as it runs on the card: each captures its step at
construction through the stub of the graph capture
(``test_torch_engine_graph.py``) and replays it every tick, and the stub
fails any replay after a buffer was rebound — so every fleet scenario also
holds the fleet's exports, scale-downs and sessions to writing in place.

The JAX fabric router reads ``y[sid]`` of a sharded array, which fails on
this jax (R1). Where the router is held against JAX, the JAX fleet is
wrapped so that its step hands the router the same outputs as a numpy
array; the JAX router's decisions run unchanged. Everything else is held
against the JAX call itself: statuses, ticks, counts and slot bookkeeping
exactly; the int8 state bitwise, the fp32 state within ``TOL_F32``;
outputs within ``TOL_HEAD`` (R6); the fp32 accounting within 1e-6
relative (R5). Within the port, every completed stream is bitwise equal to
a clean same-width reference engine (the chaos invariant).
"""
import json
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from benchmarks.loadgen_fabric import (CFG_KEYS, DEFAULTS, FABRIC_JSON,
                                       _check_parity)
from repro.dist.elastic import best_mesh as jbest_mesh
from repro.dist.elastic import scale_event as jscale_event
from repro.dist.serving import ShardedStreamFleet as JFleet
from repro.serve import engine as jengine
from repro.serve import loadgen as jloadgen
from repro.serve import resilience as jres
from repro.serve import router as jrouter
from repro.serve import scheduler as jsched
from repro_torch.dist import serving as tserving
from repro_torch.dist.elastic import Mesh, best_mesh, scale_event
from repro_torch.serve import engine as tengine
from repro_torch.serve import loadgen as tloadgen
from repro_torch.serve import resilience as tres
from repro_torch.serve import router as trouter
from repro_torch.serve import scheduler as tsched
from test_torch_resilience import JTASK, TTASK, StubGraphEngine, _programs

torch.set_num_threads(1)

TOL_HEAD = 1e-6
TOL_F32 = 1e-5
CPU = torch.device("cpu")
DEVS = [CPU] * 8
EXACT_KEYS = ("stream", "shard", "steps", "poison_steps", "bad_state_steps",
              "theta_x", "theta_h", "ticks", "n_shards", "streams_per_shard",
              "n_streams", "active_slots", "mesh", "backend", "cell")


@pytest.fixture(autouse=True)
def _graph_engines(monkeypatch):
    """The port's fleets build their shard engines as on the card."""
    monkeypatch.setattr(tserving, "DeltaStreamEngine", StubGraphEngine)


class _NumpyStepFleet(JFleet):
    """The JAX fleet, its tick's outputs handed over as a numpy array (the
    JAX router's ``y[sid]`` of the sharded array fails on this jax, R1)."""

    def step(self, x):
        return np.asarray(super().step(x))


def _fleets(backend="fused_q8", n_shards=4, streams_per_shard=2,
            jax_cls=JFleet):
    jp, tp = _programs(backend)
    n = n_shards * streams_per_shard
    return (jax_cls(jp, JTASK, n_streams=n, mesh=jbest_mesh(n_shards)),
            tserving.ShardedStreamFleet(tp, TTASK, n_streams=n,
                                        mesh=best_mesh(n_shards,
                                                       devices=DEVS)))


def _routers(n_shards, streams_per_shard, backend="fused_q8", **policy):
    jf, tf = _fleets(backend, n_shards, streams_per_shard,
                     jax_cls=_NumpyStepFleet)
    return (jrouter.StreamRouter(jf, jrouter.RouterPolicy(**policy)),
            trouter.StreamRouter(tf, trouter.RouterPolicy(**policy)))


def _same(j, t, key=""):
    """JAX and port values key by key: exact where ``EXACT_KEYS`` says so
    or the value is not a float, within 1e-6 relative otherwise (R5)."""
    if isinstance(j, dict):
        assert j.keys() == t.keys(), key
        for k in j:
            _same(j[k], t[k], k)
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), key
        for a, b in zip(j, t):
            _same(a, b, key)
    elif isinstance(j, float) and key not in EXACT_KEYS:
        assert t == pytest.approx(j, rel=1e-6), key
    else:
        assert j == t, key


def _fleet_state(fleet):
    """A port fleet's state leaves, every shard's rows in slot order."""
    per = [list(tengine._leaves(e.state.stack)) for e in fleet.engines]
    return [torch.cat(leaves).numpy() for leaves in zip(*per)]


def _same_fleet_state(jf, tf, exact):
    for a, b in zip(jax.tree_util.tree_leaves(jf.state.stack),
                    _fleet_state(tf)):
        if exact:
            np.testing.assert_array_equal(b, np.asarray(a))
        else:
            np.testing.assert_allclose(b, np.asarray(a), rtol=0,
                                       atol=TOL_F32)


def _same_host_carry(jh, th):
    assert jh.keys() == th.keys()
    for k in jh:
        j = np.asarray(jh[k])
        assert th[k].shape == j.shape and th[k].dtype == j.dtype, k
        if k in ("poison_steps", "bad_state", "agg_poison_steps",
                 "agg_bad_state", "theta_h", "last_x"):
            np.testing.assert_array_equal(th[k], j, err_msg=k)
        else:
            np.testing.assert_allclose(th[k], j, rtol=1e-6, err_msg=k)


def _engine_leaves(eng):
    """An engine's state and rollback shadow as numpy arrays, of either
    package."""
    if isinstance(eng, tengine.DeltaStreamEngine):
        return [t.numpy() for tree in (eng.state, eng._snap_state)
                for t in tengine._leaves(tree.stack)]
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(
        (eng.state.stack, eng._snap_state.stack))]


def _history(results):
    return [(r.uid, r.shard, r.status, r.submit_tick, r.done_tick,
             r.replayed, r.error) for r in results]


def _same_results(jresults, tresults):
    """Two routers' terminal results: the same events, outputs within
    ``TOL_HEAD``, per-stream accounting per R5."""
    assert _history(tresults) == _history(jresults)
    for j, t in zip(jresults, tresults):
        assert (j.outputs is None) == (t.outputs is None)
        if j.outputs is not None:
            np.testing.assert_allclose(np.stack(t.outputs),
                                       np.stack(j.outputs), rtol=0,
                                       atol=TOL_HEAD)
        if j.stats is not None:
            _same({k: v for k, v in j.stats.items() if k != "uid"},
                  {k: v for k, v in t.stats.items() if k != "uid"})


def _same_books(jr, tr):
    assert tr.conservation() == jr.conservation()
    jrep, trep = jr.report(), tr.report()
    _same(jrep, trep)


def _arrivals(n, rate, lo, hi, seed, width=8):
    """The port's schedule, checked draw for draw against JAX's."""
    t = tloadgen.poisson_arrivals(n, rate, min_len=lo, max_len=hi,
                                  input_size=width, seed=seed)
    j = jloadgen.poisson_arrivals(n, rate, min_len=lo, max_len=hi,
                                  input_size=width, seed=seed)
    assert [a for a, _ in t] == [a for a, _ in j]
    assert all(x.tobytes() == y.tobytes() for (_, x), (_, y) in zip(t, j))
    return t


def _jax_engine_parity(arrivals, results, b, backend="fused_q8",
                       groups=None):
    """Completed streams against the JAX single-device engine of the
    per-shard width (R1: the JAX fleet's router cannot be the reference),
    B streams a reference run, as ``_check_parity`` pads them."""
    ref = jengine.DeltaStreamEngine(_programs(backend)[0], JTASK,
                                    n_streams=b)
    completed = [(i, r) for i, r in sorted(results.items())
                 if r.status == "ok"]
    bases = range(0, len(completed), b)
    for base in (bases if groups is None else bases[:groups]):
        group = completed[base:base + b]
        t_max = max(len(arrivals[i][1]) for i, _ in group)
        xs = np.zeros((t_max, b, 8), np.float32)
        for j, (i, _) in enumerate(group):
            frames = arrivals[i][1]
            xs[:len(frames), j] = frames
            xs[len(frames):, j] = frames[-1]
        ref.reset()
        want = np.asarray(ref.step_many(xs))
        for j, (i, r) in enumerate(group):
            got = np.stack(r.outputs)
            np.testing.assert_allclose(got, want[:len(got), j], rtol=0,
                                       atol=TOL_HEAD)
    return ref


class TestElasticValidation:
    @pytest.mark.parametrize("n", [0, -3])
    def test_best_mesh_rejects_nonpositive(self, n):
        with pytest.raises(ValueError, match="n_devices") as te:
            best_mesh(n, devices=DEVS)
        with pytest.raises(ValueError) as je:
            jbest_mesh(n)
        assert str(te.value) == str(je.value)

    def test_best_mesh_none_takes_all_devices(self):
        assert best_mesh(None, devices=DEVS).shape == dict(
            jbest_mesh(None).shape)
        assert best_mesh(None, devices=[CPU] * 3).shape == {"data": 3,
                                                             "model": 1}
        assert best_mesh(12, devices=DEVS).shape["data"] == 8   # clamped

    @pytest.mark.parametrize("model_parallel", [1, 2, 3])
    @pytest.mark.parametrize("n", range(1, 9))
    def test_mesh_and_plan_match_jax(self, n, model_parallel):
        tm, jm = best_mesh(n, model_parallel, devices=DEVS), jbest_mesh(
            n, model_parallel)
        assert tm.shape == dict(jm.shape)
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.devices.shape == jm.devices.shape
        assert all(d == CPU for d in tm.devices.flat)
        assert scale_event(best_mesh(8, devices=DEVS), n, model_parallel) \
            == jscale_event(jbest_mesh(8), n, model_parallel)

    @pytest.mark.parametrize("n", [0, -1])
    def test_scale_event_rejects_scale_to_zero(self, n):
        with pytest.raises(ValueError, match="n_devices") as te:
            scale_event(best_mesh(4, devices=DEVS), n)
        with pytest.raises(ValueError) as je:
            jscale_event(jbest_mesh(4), n)
        assert str(te.value) == str(je.value)

    def test_mesh_needs_one_dimension_a_name(self):
        with pytest.raises(ValueError, match="axis names"):
            Mesh(np.array([CPU] * 4, dtype=object), ("data", "model"))


class TestFleet:
    def test_indivisible_widths_named_in_error(self):
        jp, tp = _programs()
        with pytest.raises(ValueError) as te:
            tserving.ShardedStreamFleet(tp, TTASK, n_streams=30,
                                        mesh=best_mesh(8, devices=DEVS))
        with pytest.raises(ValueError) as je:
            JFleet(jp, JTASK, n_streams=30, mesh=jbest_mesh(8))
        assert str(te.value) == str(je.value)
        assert "24 (3/shard)" in str(te.value) \
            and "32 (4/shard)" in str(te.value)

    def test_fleet_needs_data_axis(self):
        mesh = Mesh(np.array([CPU] * 4, dtype=object), ("model",))
        with pytest.raises(ValueError, match="data"):
            tserving.ShardedStreamFleet(_programs()[1], TTASK, n_streams=8,
                                        mesh=mesh)

    @pytest.mark.parametrize("shape", [(4, 2), (8, 2)])
    @pytest.mark.parametrize("backend", ["fused", "fused_q8"])
    def test_step_and_step_many_match_jax(self, backend, shape):
        """Ticks through ``step`` then a chunk through ``step_many``: the
        port's fleet against JAX's (outputs within R6's bound, the int8
        state bitwise, fp32 within TOL_F32), and each of its shards
        bitwise a standalone engine of the tile width fed its rows."""
        jf, tf = _fleets(backend, *shape)
        b = tf.streams_per_shard
        xs = np.random.default_rng(0).standard_normal(
            (12, tf.n_streams, 8)).astype(np.float32)
        t_out = torch.cat([torch.stack([tf.step(x) for x in xs[:6]]),
                           tf.step_many(xs[6:])]).numpy()
        j_out = np.concatenate([np.stack([np.asarray(jf.step(x))
                                          for x in xs[:6]]),
                                np.asarray(jf.step_many(xs[6:]))])
        np.testing.assert_allclose(t_out, j_out, rtol=0, atol=TOL_HEAD)
        _same_fleet_state(jf, tf, exact=backend == "fused_q8")
        for s in range(tf.n_shards):
            ref = tf.reference_engine()
            want = ref.step_many(xs[:, s * b:(s + 1) * b]).numpy()
            assert want.tobytes() == t_out[:, s * b:(s + 1) * b].tobytes()
            for x, y in zip(tengine._leaves(ref.state.stack),
                            tengine._leaves(tf.engines[s].state.stack)):
                assert torch.equal(x, y)
        # one capture a shard; a replay a shard a tick
        assert tf.graph_stats == {"captures": tf.n_shards,
                                  "replays": 12 * tf.n_shards, "ticks": 12}

    def test_carry_sessions_and_report_match_jax(self):
        jf, tf = _fleets("fused_q8", 4, 2)
        for f in (jf, tf):
            assert [f.open_stream(s) for s in (2, 2, 0)] == [4, 5, 0]
            assert f.shard_of(5) == 2 and f.active_slots(2) == 2
            assert f.active_slots() == 3 and f.free_streams(2) == []
            assert f.free_streams(0) == [1]
        xs = np.random.default_rng(1).standard_normal(
            (7, 8, 8)).astype(np.float32)
        xs[3, 5, 0] = np.nan
        xs[4, 0, :] = np.inf
        for x in xs:
            jf.step(x)
            tf.step(x)
        jh, th = jax.device_get(jf._carry), tf.host_carry()
        _same_host_carry(jh, th)
        assert th["poison_steps"].tolist() == [1, 0, 0, 0, 0, 1, 0, 0]
        _same(jf.close_stream(5, host_carry=jh),
              tf.close_stream(5, host_carry=th))
        _same(jf.close_stream(4), tf.close_stream(4))
        for s in range(4):
            _same(asdict(jf.shard_stats(s)), asdict(tf.shard_stats(s)))
        _same(jf.report(), tf.report())
        for f in (jf, tf):
            with pytest.raises(ValueError, match="not open"):
                f.close_stream(4)

    def test_open_stream_claims_the_first_free_slot(self):
        jf, tf = _fleets("fused", 2, 2)
        for f in (jf, tf):
            assert [f.open_stream(1), f.open_stream(1)] == [2, 3]
            with pytest.raises(RuntimeError, match="all 2 slots busy"):
                f.open_stream(1)
            f.close_stream(2)
            assert f.open_stream(1) == 2
            with pytest.raises(ValueError, match="out of range"):
                f.open_stream(2)
        with pytest.raises(RuntimeError) as te:
            tf.open_stream(1)
        with pytest.raises(RuntimeError) as je:
            jf.open_stream(1)
        assert str(te.value) == str(je.value)

    def test_remove_shard_matches_jax_and_survivors_continue_bitwise(self):
        jf, tf = _fleets("fused_q8", 4, 2)
        for f in (jf, tf):
            for s in (1, 1, 2):
                f.open_stream(s)
        rng = np.random.default_rng(2)
        xs1 = rng.standard_normal((5, 8, 8)).astype(np.float32)
        xs2 = rng.standard_normal((6, 6, 8)).astype(np.float32)
        jf.step_many(xs1)
        tf.step_many(xs1)
        survivors = [tf.engines[s] for s in (0, 2, 3)]
        ti, ji = tf.remove_shard(1), jf.remove_shard(1)
        assert ti == ji
        assert ti["displaced"] == [2, 3] and ti["checkpoint"] is None
        assert tf.engines == survivors and tf.n_streams == 6
        assert tf.mesh.shape == ji["plan"]["new_shape"]
        assert all(e.graph_stats["captures"] == 1 for e in tf.engines)
        t_out = tf.step_many(xs2).numpy()
        np.testing.assert_allclose(t_out, np.asarray(jf.step_many(xs2)),
                                   rtol=0, atol=TOL_HEAD)
        _same_fleet_state(jf, tf, exact=True)
        _same(jf.report(), tf.report())
        # the survivors' streams continue with exactly their bits
        for new, old in enumerate((0, 2, 3)):
            ref = tf.reference_engine()
            ref.step_many(xs1[:, 2 * old:2 * old + 2])
            want = ref.step_many(xs2[:, 2 * new:2 * new + 2]).numpy()
            assert want.tobytes() == t_out[:, 2 * new:2 * new + 2].tobytes()
        assert tf.graph_stats == {"captures": 4, "replays": 4 * 5 + 3 * 6,
                                  "ticks": 11}
        with pytest.raises(ValueError, match="out of range"):
            tf.remove_shard(3)

    def test_drain_checkpoints_restore_across_packages(self, tmp_path):
        """A shard's export is a new engine (never the live one); the
        port's drain checkpoint restores into the JAX engine and the JAX
        fleet's into the port's, each bitwise the other package's export,
        and the restored engine steps on bitwise with the live shard."""
        jf, tf = _fleets("fused_q8", 4, 2)
        rng = np.random.default_rng(3)
        xs = rng.standard_normal((6, 8, 8)).astype(np.float32)
        xs[2, 5, 1] = np.nan
        for f in (jf, tf):
            f.open_stream(2)
            f.step_many(xs[:3])
            f.open_stream(2)
            f.step_many(xs[3:])
        tx, jx = tf.export_shard_engine(2), jf.export_shard_engine(2)
        assert tx is not tf.engines[2]
        assert tx._slot_busy == [True, True] and tx._n_steps == 6
        assert tx._slot_opened_at == [0, 3] == jx._slot_opened_at
        assert tx._snap_steps == [6, 3] == jx._snap_steps
        # the two packages' exports: state and shadows bitwise (int8),
        # carry and shadow carry per R5
        for a, b in zip(_engine_leaves(tx), _engine_leaves(jx)):
            np.testing.assert_array_equal(a, b)
        _same_host_carry(jax.device_get(jx._carry),
                         {k: v.numpy() for k, v in tx._carry.items()})
        _same_host_carry(jax.device_get(jx._snap_carry),
                         {k: v.numpy() for k, v in tx._snap_carry.items()})
        tf.checkpoint_shard(2, str(tmp_path / "torch"))
        jf.checkpoint_shard(2, str(tmp_path / "jax"))
        je = jengine.DeltaStreamEngine.restore(
            str(tmp_path / "torch"), jf.program, JTASK, n_streams=2)
        te = StubGraphEngine.restore(str(tmp_path / "jax"), tf.program,
                                     TTASK, n_streams=2)
        for got, want in ((je, tx), (te, jx)):
            for a, b in zip(_engine_leaves(got), _engine_leaves(want)):
                np.testing.assert_array_equal(a, b)
            for k in want._carry:
                np.testing.assert_array_equal(np.asarray(got._carry[k]),
                                              np.asarray(want._carry[k]))
                np.testing.assert_array_equal(
                    np.asarray(got._snap_carry[k]),
                    np.asarray(want._snap_carry[k]))
            assert (got._n_steps, got._slot_busy, got._slot_opened_at,
                    got._snap_steps) == (want._n_steps, want._slot_busy,
                                         want._slot_opened_at,
                                         want._snap_steps)
        _same(je.report(), tx.report())
        more = rng.standard_normal((4, 8, 8)).astype(np.float32)
        live = tf.step_many(more)[:, 4:6].numpy()
        for eng in (te, tx):
            assert eng.step_many(more[:, 4:6]).numpy().tobytes() \
                == live.tobytes()


class TestRouter:
    def test_fabric_conservation_and_parity(self):
        jr, tr = _routers(4, 2, max_queue=4)
        arrivals = _arrivals(30, 3.0, 3, 8, seed=3)
        summary = tloadgen.run_fabric_load(tr, arrivals)
        jloadgen.run_fabric_load(jr, arrivals)
        cons = tr.conservation()
        assert cons["conserved"] and cons["queued"] == 0 \
            and cons["in_flight"] == 0
        assert cons["submitted"] == len(arrivals) \
            == cons["completed"] + cons["rejected"] + cons["shed"]
        assert cons["frames_conserved"] and cons["frames_out"] > 0
        assert _check_parity(arrivals, summary.results, tr.fleet) \
            == cons["completed"]
        rep = tr.report()
        for key in ("submitted", "completed", "rejected", "frames_out",
                    "harvested_steps"):
            assert sum(b[key] for b in rep["per_shard"]) == cons[key], key
        _same_results(jr.results, tr.results)
        _same_books(jr, tr)
        _jax_engine_parity(arrivals, summary.results, 2)

    def test_jsq_spreads_an_idle_fleet(self):
        _, tf = _fleets("fused_q8", 4, 2)
        router = trouter.StreamRouter(tf, trouter.RouterPolicy())
        frames = np.ones((3, 8), np.float32)
        for _ in range(4):
            router.submit(frames)
        shards = [q_id for q_id, q in enumerate(router.queues) for _ in q]
        assert sorted(shards) == [0, 1, 2, 3]

    def test_reject_and_deadline_match_jax(self):
        """A full queue rejects (a terminal result); a deadline sheds
        queued streams, never running ones; each as the JAX router does."""
        jr, tr = _routers(2, 1, max_queue=1)
        frames = np.ones((3, 8), np.float32)
        for r in (jr, tr):
            assert [r.submit(frames)[1] for _ in range(4)] \
                == [True, True, False, False]
            rejected = [x for x in r.results if x.status == "rejected"]
            assert len(rejected) == 2
            assert all(x.error["reason"] == "queue_full" for x in rejected)
            r.run_until_drained()
            assert r.conservation()["conserved"]
        _same_results(jr.results, tr.results)
        jr, tr = _routers(2, 1, max_queue=8, deadline_ticks=2)
        frames = np.ones((20, 8), np.float32)
        for r in (jr, tr):
            for _ in range(6):
                r.submit(frames)
            done = r.run_until_drained()
            assert sum(x.status == "ok" for x in done) == 2
            assert sum(x.status == "shed" for x in done) == 4
            assert r.conservation()["shed"] == 4
        _same_results(jr.results, tr.results)
        _same_books(jr, tr)

    def test_nonfinite_admission_matches_batcher_semantics(self):
        _, tf = _fleets("fused_q8", 2, 1)
        router = trouter.StreamRouter(tf, trouter.RouterPolicy())
        bad = np.ones((3, 8), np.float32)
        bad[1, 0] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            router.submit(bad)
        with pytest.raises(ValueError, match="frames must be"):
            router.submit(np.ones((3, 7), np.float32))
        with pytest.raises(ValueError, match="on_nonfinite"):
            trouter.StreamRouter(tf, trouter.RouterPolicy(
                on_nonfinite="drop"))

    def test_pool_mode_batchers_match_jax(self):
        jp, tp = _programs()
        routers = {}
        for name, prog, task, Engine, Batcher, R, kw in (
                ("jax", jp, JTASK, jengine.DeltaStreamEngine,
                 jsched.DeltaStreamBatcher, jrouter, {}),
                ("torch", tp, TTASK, StubGraphEngine,
                 tsched.DeltaStreamBatcher, trouter, {})):
            workers = [Batcher(Engine(prog, task, n_streams=2, **kw))
                       for _ in range(3)]
            router = R.StreamRouter(workers, R.RouterPolicy(max_queue=4))
            routers[name] = router
        arrivals = _arrivals(20, 3.0, 3, 8, seed=5)
        summary = tloadgen.run_fabric_load(routers["torch"], arrivals)
        jloadgen.run_fabric_load(routers["jax"], arrivals)
        cons = routers["torch"].conservation()
        assert cons["conserved"] and cons["frames_conserved"]
        assert cons["submitted"] == 20
        assert all(r.status in ("ok", "rejected")
                   for r in summary.results.values())
        assert sum(p.worker.counters["harvested"]
                   for p in routers["torch"].ports) == cons["completed"]
        _same_results(routers["jax"].results, routers["torch"].results)
        _same_books(routers["jax"], routers["torch"])

    def test_pool_mode_resilient_statuses_match_jax(self):
        jp, tp = _programs()
        routers = {}
        for name, prog, task, Engine, sched, res, R in (
                ("jax", jp, JTASK, jengine.DeltaStreamEngine, jsched, jres,
                 jrouter),
                ("torch", tp, TTASK, StubGraphEngine, tsched, tres,
                 trouter)):
            workers = [res.ResilientStreamServer(
                sched.DeltaStreamBatcher(Engine(prog, task, n_streams=2)),
                res.ResiliencePolicy(max_queue=8, quarantine_after=1,
                                     on_quarantine="reject"))
                for _ in range(2)]
            routers[name] = R.StreamRouter(workers, R.RouterPolicy(
                max_queue=8, on_nonfinite="quarantine"))
        arrivals = _arrivals(12, 3.0, 3, 8, seed=7)
        bad = arrivals[4][1].copy()
        bad[0, 0] = np.inf
        arrivals[4] = (arrivals[4][0], bad)
        summary = tloadgen.run_fabric_load(routers["torch"], arrivals)
        jloadgen.run_fabric_load(routers["jax"], arrivals)
        statuses = sorted(r.status for r in summary.results.values())
        assert statuses.count("quarantined") == 1
        cons = routers["torch"].conservation()
        assert cons["conserved"] and cons["quarantined"] == 1
        _same_results(routers["jax"].results, routers["torch"].results)
        _same_books(routers["jax"], routers["torch"])

    def test_pool_rejects_unknown_worker_type(self):
        with pytest.raises(TypeError, match="not a"):
            trouter.StreamRouter([object()])
        with pytest.raises(ValueError, match="at least one worker"):
            trouter.StreamRouter([])

    def test_scale_down_is_fabric_only(self):
        workers = [tsched.DeltaStreamBatcher(
            StubGraphEngine(_programs()[1], TTASK, n_streams=2))]
        router = trouter.StreamRouter(workers)
        with pytest.raises(RuntimeError, match="fabric-mode"):
            router.scale_down(0)


class TestRebalance:
    def test_replayed_streams_complete_bitwise(self, tmp_path):
        """A shard dies mid-load with streams queued and in flight; its
        drain checkpoint restores on a single engine of either package;
        the displaced streams replay on survivors and every completed
        stream matches a clean reference bitwise; the whole event history
        is the JAX router's."""
        jr, tr = _routers(4, 2, max_queue=8)
        arrivals = _arrivals(28, 4.0, 4, 10, seed=11)
        summary = tloadgen.run_fabric_load(
            tr, arrivals, scale_down_at=3, scale_down_shard=1,
            ckpt_dir=str(tmp_path / "torch"))
        jsummary = jloadgen.run_fabric_load(
            jr, arrivals, scale_down_at=3, scale_down_shard=1,
            ckpt_dir=str(tmp_path / "jax"))
        fleet = tr.fleet
        assert summary.scale_info is not None
        assert fleet.n_shards == 3 and tr.n_shards == 3
        cons = tr.conservation()
        assert cons["conserved"] and cons["frames_conserved"]
        assert cons["rebalanced"] > 0
        replayed = [r for r in summary.results.values() if r.replayed]
        assert len(replayed) == cons["rebalanced"]
        assert all(r.status == "ok" for r in replayed)
        assert _check_parity(arrivals, summary.results, fleet) \
            == cons["completed"]
        _same_results(jr.results, tr.results)
        _same_books(jr, tr)
        info = {k: v for k, v in summary.scale_info.items()
                if k != "checkpoint"}
        assert info == {k: v for k, v in jsummary.scale_info.items()
                        if k != "checkpoint"}
        _jax_engine_parity(arrivals, summary.results, 2)
        for ckpt in ("torch", "jax"):
            eng = StubGraphEngine.restore(str(tmp_path / ckpt),
                                          fleet.program, TTASK,
                                          n_streams=fleet.streams_per_shard)
            assert eng.n_streams == fleet.streams_per_shard
            jeng = jengine.DeltaStreamEngine.restore(
                str(tmp_path / ckpt), jr.fleet.program, JTASK,
                n_streams=fleet.streams_per_shard)
            for a, b in zip(jax.tree_util.tree_leaves(jeng.state.stack),
                            tengine._leaves(eng.state.stack)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    def test_displaced_latency_keeps_original_submit_tick(self, tmp_path):
        jr, tr = _routers(2, 2, max_queue=8)
        frames = np.ones((6, 8), np.float32)
        for r, name in ((jr, "jax"), (tr, "torch")):
            uids = [r.submit(frames)[0] for _ in range(4)]
            r.tick()
            info = r.scale_down(0, ckpt_dir=str(tmp_path / name))
            assert info["replayed"] > 0
            by_uid = {x.uid: x for x in r.run_until_drained()}
            for uid in uids:
                x = by_uid[uid]
                assert x.status == "ok" and x.submit_tick == 0
                if x.replayed:
                    assert x.latency_ticks >= 6
        _same_results(jr.results, tr.results)

    def test_cannot_scale_below_one_shard(self):
        _, tf = _fleets("fused_q8", 2, 1)
        router = trouter.StreamRouter(tf)
        router.scale_down(0)
        with pytest.raises(ValueError, match="below one shard"):
            router.scale_down(0)
        with pytest.raises(ValueError, match="n_devices"):
            tf.remove_shard(0)


def _counts(router, summary, fleet, parity_ok) -> dict:
    """``benchmarks/loadgen_fabric.py``'s counts block of one run."""
    cons = router.conservation()
    results = summary.results
    ok_lat = sorted(r.latency_ticks for r in results.values()
                    if r.status == "ok")
    rep = router.report()
    return {
        "submitted": cons["submitted"], "completed": cons["completed"],
        "rejected": cons["rejected"], "shed": cons["shed"],
        "rebalanced": cons["rebalanced"],
        "replayed_completed": sum(r.replayed for r in results.values()),
        "parity_ok": parity_ok, "frames_out": cons["frames_out"],
        "harvested_steps": cons["harvested_steps"], "ticks": summary.ticks,
        "peak_concurrent": summary.peak_concurrent,
        "peak_concurrent_full": summary.peak_concurrent_full,
        "peak_active": summary.peak_active,
        "latency_ticks_p50": ok_lat[len(ok_lat) // 2],
        "latency_ticks_p99": ok_lat[min(len(ok_lat) - 1,
                                        int(0.99 * len(ok_lat)))],
        "per_shard_completed": (
            [b["completed"] for b in rep["retired_shards"]]
            + [b["completed"] for b in rep["per_shard"]]),
        "fleet_shards_final": fleet.n_shards,
    }


class TestBenchFabric:
    def test_port_reproduces_bench_fabric_counts(self, tmp_path):
        """``BENCH_fabric.json``'s committed configuration through the
        port: its tick-exact counts exactly, all completed streams bitwise
        equal to the port's reference engine (the bench's own checker),
        and the first group against the JAX engine at width 128."""
        record = json.loads(open(FABRIC_JSON).read())
        c = {k: record["config"][k] for k in CFG_KEYS}
        assert c == DEFAULTS
        assert (c["input"], c["hidden"], c["layers"]) == (
            TTASK.input_size, TTASK.hidden_size, TTASK.num_layers)
        n = c["n_shards"] * c["streams_per_shard"]
        fleet = tserving.ShardedStreamFleet(
            _programs("fused_q8")[1], TTASK, n_streams=n,
            mesh=best_mesh(c["n_shards"], devices=DEVS))
        router = trouter.StreamRouter(
            fleet, trouter.RouterPolicy(max_queue=c["max_queue"]))
        arrivals = _arrivals(c["n_arrivals"], c["rate_per_tick"],
                             c["min_len"], c["max_len"], seed=c["seed"])
        summary = tloadgen.run_fabric_load(
            router, arrivals, scale_down_at=c["scale_down_at"],
            scale_down_shard=c["scale_down_shard"],
            ckpt_dir=str(tmp_path))
        assert summary.scale_info["checkpoint"]
        parity_ok = _check_parity(arrivals, summary.results, fleet)
        assert _counts(router, summary, fleet, parity_ok) \
            == record["counts"]
        assert parity_ok == record["counts"]["completed"] == 1733
        # one group against the JAX engine at the tile width
        jref = _jax_engine_parity(arrivals, summary.results,
                                  c["streams_per_shard"], groups=1)
        tref = fleet.reference_engine()
        completed = [i for i, r in sorted(summary.results.items())
                     if r.status == "ok"][:c["streams_per_shard"]]
        t_max = max(len(arrivals[i][1]) for i in completed)
        xs = np.zeros((t_max, len(completed), 8), np.float32)
        for j, i in enumerate(completed):
            xs[:len(arrivals[i][1]), j] = arrivals[i][1]
            xs[len(arrivals[i][1]):, j] = arrivals[i][1][-1]
        tref.step_many(xs)
        for a, b in zip(jax.tree_util.tree_leaves(jref.state.stack),
                        tengine._leaves(tref.state.stack)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


class TestObservabilityHooks:
    def _batcher(self, n_streams=2):
        return tsched.DeltaStreamBatcher(
            StubGraphEngine(_programs()[1], TTASK, n_streams=n_streams))

    def test_batcher_hooks_and_counters(self):
        b = self._batcher()
        frames = np.ones((4, 8), np.float32)
        for _ in range(3):
            b.submit(frames, on_nonfinite="allow")
        assert b.counters["submitted"] == 3
        assert b.queue_depth() == 3 and b.active_slots() == 0
        assert b.free_slots() == 0
        b.run_until_drained()
        assert b.queue_depth() == 0 and b.active_slots() == 0
        assert b.counters["admitted"] == 3
        assert b.counters["harvested"] == 3
        assert b.counters["ticks"] > 0

    def test_resilient_server_reads_pressure_through_hooks(self):
        b = self._batcher()
        srv = tres.ResilientStreamServer(b, tres.ResiliencePolicy(
            max_queue=4))
        assert srv.queue_depth() == 0 and srv.free_slots() == 2
        b.queue_depth = lambda: 99
        uid, admitted = srv.submit(np.ones((4, 8), np.float32))
        assert not admitted
        assert srv.results[-1].error["reason"] == "queue_full"
        assert srv.results[-1].error["depth"] == 99
