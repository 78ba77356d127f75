"""The port's resilience tier (``serve/faults.py``, ``serve/resilience.py``,
the engine's snapshot/rollback and checkpoint/restore) against the JAX
package's, on the CPU, at the JAX tests' size (I=8, H=16, 2 layers, 3
outputs): every class of ``tests/test_resilience.py``, each run through
both packages on the same numpy inputs and JAX-made weights.

The port's engines here are the fixed-buffer engine as it runs on the card:
it captures its step at construction (through the stub of the graph capture
of ``test_torch_engine_graph.py``) and replays it every step, and the stub
fails any replay after a buffer was rebound. So every scenario below also
holds restore, corruption, rollback and the supervisor to writing in place.

Held: statuses, counters, Θ peak, slot bookkeeping and fault schedules
exactly; ``report()`` key by key per R5 (counts, names and θ exactly, the
fp32 accounting within 1e-6 relative); outputs within ``TOL_HEAD`` (R6, the
fp32 head); the int8/int4 state bitwise, the fp32 state within
``TOL_F32``. Within the port, the chaos invariant is bitwise: every
completed stream equals a clean same-width run of its sanitized frames.
"""
import functools
import json
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_1_6b as jrwkv_cfg
from repro.core.program import compile_delta_program as jcompile
from repro.models import gru_rnn as jmodels
from repro.quant.export import quantize_delta_model as jquant
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import resilience as jres
from repro.serve import scheduler as jsched
from repro_torch.core.program import compile_delta_program as tcompile
from repro_torch.core.thresholds import ThresholdPolicy as TThresholds
from repro_torch.models import gru_rnn as tmodels
from repro_torch.quant.export import quantize_delta_model as tquant
from repro_torch.serve import engine as tengine
from repro_torch.serve import faults as tfaults
from repro_torch.serve import resilience as tres
from repro_torch.serve import scheduler as tsched
from test_torch_engine_graph import buffer_ptrs, stub_capture

torch.set_num_threads(1)

TOL_HEAD = 1e-6
TOL_F32 = 1e-5
EXACT_FLOAT_KEYS = ("theta_x", "theta_h", "poison_steps", "bad_state_steps")
WALL_KEYS = ("straggler_flags", "missed_heartbeats")


def _task(models):
    return models.GruTaskConfig(8, 16, 2, 3, task="regression",
                                theta_x=0.05, theta_h=0.05)


JTASK, TTASK = _task(jmodels), _task(tmodels)


@functools.lru_cache(maxsize=None)
def _programs(backend="fused", cell="gru", key=0):
    """The same JAX-made weights compiled by both packages."""
    init = jmodels.init_gru_model if cell == "gru" else jmodels.init_lstm_model
    jp = init(jax.random.PRNGKey(key), JTASK)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    if backend in ("fused_q8", "fused_q4"):
        bits = 8 if backend == "fused_q8" else 4
        return jquant(jp, bits=bits), tquant(tp, bits=bits, device="cpu")
    return (jcompile(jp, backend, cell=cell),
            tcompile(tp, backend, cell=cell, device="cpu"))


class StubGraphEngine(tengine.DeltaStreamEngine):
    """The port's engine as on the card: it captures its step at
    construction and replays it every step (through the stub capture), so
    a restore writes into buffers a graph already captured."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)
        self._capture = stub_capture
        self._capture_step()


JAX = SimpleNamespace(
    name="jax", Engine=jengine.DeltaStreamEngine, engine_kw={}, task=JTASK,
    prog=lambda *a, **k: _programs(*a, **k)[0],
    Batcher=jsched.DeltaStreamBatcher, res=jres, faults=jfaults,
    carry=lambda eng: jax.device_get(eng._carry),
    leaves=lambda tree: [np.asarray(x)
                         for x in jax.tree_util.tree_leaves(tree)])
TORCH = SimpleNamespace(
    name="torch", Engine=StubGraphEngine, engine_kw={"device": "cpu"},
    task=TTASK, prog=lambda *a, **k: _programs(*a, **k)[1],
    Batcher=tsched.DeltaStreamBatcher, res=tres, faults=tfaults,
    carry=lambda eng: eng.host_carry(),
    leaves=lambda tree: [x.numpy() for x in tengine._leaves(tree)])
PKGS = (JAX, TORCH)


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _frames(t, rng):
    return rng.standard_normal((t, 8)).astype(np.float32)


def _same_report(jr, tr):
    """Reports (engine, server, counters) key by key per R5; the wall-clock
    figures are left out."""
    wall = WALL_KEYS + ("p99_tick_wall_s",)
    jr = {k: v for k, v in jr.items() if k not in wall}
    tr = {k: v for k, v in tr.items() if k not in wall}
    assert jr.keys() == tr.keys()
    for k in jr:
        if isinstance(jr[k], dict):
            _same_report(jr[k], tr[k])
        elif isinstance(jr[k], float) and k not in EXACT_FLOAT_KEYS:
            assert tr[k] == pytest.approx(jr[k], rel=1e-6), k
        else:
            assert jr[k] == tr[k], k


def _same_state(jeng, teng, exact):
    for a, b in zip(JAX.leaves(jeng.state.stack),
                    TORCH.leaves(teng.state.stack)):
        if exact:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_F32)


def _close(t_out, j_out):
    np.testing.assert_allclose(_arr(t_out), _arr(j_out), rtol=0,
                               atol=TOL_HEAD)


def _outputs(res):
    return np.stack([_arr(o) for o in res.outputs])


def _ref_outputs(P, backend, frames, n_streams=2):
    """A clean same-width run of ``frames`` through slot 0."""
    ref = P.Engine(P.prog(backend), P.task, n_streams=n_streams)
    ref.open_stream()
    xs = np.zeros((len(frames), n_streams, 8), np.float32)
    xs[:, 0] = frames
    return _arr(ref.step_many(xs))[:, 0]


class TestFrameGuard:
    @pytest.mark.parametrize("backend", ["fused", "fused_q8"])
    @pytest.mark.parametrize("kind", [np.nan, np.inf])
    def test_guard_equals_sanitized_feed_bitwise(self, backend, kind):
        frames = _frames(30, np.random.default_rng(0))
        frames[5, 2] = kind
        frames[17, :] = kind
        got = {}
        for P in PKGS:
            eng = P.Engine(P.prog(backend), P.task)
            got[P.name] = _arr(eng.step_many(frames))
            assert np.isfinite(got[P.name]).all()
            ctrl = P.Engine(P.prog(backend), P.task)
            want = _arr(ctrl.step_many(P.faults.sanitize_frames(frames)))
            np.testing.assert_array_equal(got[P.name], want)
            assert eng.stats.poison_steps == 2.0
            assert eng.report()["poison_steps"] == 2.0
            assert ctrl.stats.poison_steps == 0.0
        _close(got["torch"], got["jax"])

    def test_poisoned_frame_zero(self):
        frames = _frames(10, np.random.default_rng(1))
        frames[0, :] = np.nan
        got = {}
        for P in PKGS:
            got[P.name] = _arr(P.Engine(P.prog(), P.task).step_many(frames))
            want = P.Engine(P.prog(), P.task).step_many(
                P.faults.sanitize_frames(frames))
            np.testing.assert_array_equal(got[P.name], _arr(want))
        _close(got["torch"], got["jax"])

    def test_per_slot_poison_counters_and_companion_isolation(self):
        xs = np.random.default_rng(2).standard_normal((25, 4, 8)).astype(
            np.float32)
        clean = xs.copy()
        xs[3, 1, 0] = np.nan
        xs[9, 1, :] = np.inf
        got = {}
        for P in PKGS:
            eng = P.Engine(P.prog("fused_q8"), P.task, n_streams=4)
            got[P.name] = _arr(eng.step_many(xs))
            assert P.carry(eng)["poison_steps"].tolist() == [0, 2, 0, 0]
            assert eng.stats.poison_steps == 2.0
            ctrl = P.Engine(P.prog("fused_q8"), P.task, n_streams=4)
            want = _arr(ctrl.step_many(clean))
            for s in (0, 2, 3):
                np.testing.assert_array_equal(got[P.name][:, s], want[:, s])
            got[P.name + " state"] = eng
        _close(got["torch"], got["jax"])
        _same_state(got["jax state"], got["torch state"], exact=True)

    def test_session_reset_zeroes_poison_and_guard_memory(self):
        for P in PKGS:
            eng = P.Engine(P.prog(), P.task, n_streams=2)
            eng.step_many(np.full((4, 2, 8), np.nan, np.float32))
            assert eng.stats.poison_steps == 8.0
            sid = eng.open_stream()
            assert P.carry(eng)["poison_steps"][sid] == 0.0
            last_x = _arr(eng._carry["last_x"])
            np.testing.assert_array_equal(last_x[sid], np.zeros(8))
            assert eng.stats.poison_steps == 8.0

    def test_bad_state_counter_flags_corrupted_slot(self):
        engines = {}
        for P in PKGS:
            rng = np.random.default_rng(3)
            eng = P.Engine(P.prog(), P.task, n_streams=3)
            eng.step_many(rng.standard_normal((5, 3, 8)).astype(np.float32))
            P.faults.corrupt_slot_state(eng, 1)
            eng.step_many(rng.standard_normal((4, 3, 8)).astype(np.float32))
            assert P.carry(eng)["bad_state"].tolist() == [0.0, 4.0, 0.0]
            assert eng.stats.bad_state_steps == 4.0
            engines[P.name] = eng
        for a, b in zip(JAX.leaves(engines["jax"].state.stack),
                        TORCH.leaves(engines["torch"].state.stack)):
            np.testing.assert_array_equal(np.isnan(b), np.isnan(a))
        with pytest.raises(ValueError, match="out of range"):
            tfaults.corrupt_slot_state(engines["torch"], 3)

    def test_corruption_skips_non_float_leaves(self):
        eng = StubGraphEngine(TORCH.prog(), TTASK, n_streams=2)
        flags = torch.zeros((2, 5), dtype=torch.int8)
        eng.state = tengine.replace(eng.state, stack=eng.state.stack._replace(
            layers=eng.state.stack.layers + (flags,)))
        tfaults.corrupt_slot_state(eng, 0)
        assert torch.equal(flags, torch.zeros((2, 5), dtype=torch.int8))
        assert torch.isnan(eng.state.stack.layers[0].h[0]).all()
        assert not torch.isnan(eng.state.stack.layers[0].h[1]).any()

    @pytest.mark.parametrize("seed", [0, 99])
    def test_fault_plans_and_sanitize_match_jax_bitwise(self, seed):
        rng = np.random.default_rng(seed)
        kw = dict(seed=seed, poison_streams=(1, 7), inf_streams=(4,),
                  poison_frames=3, corrupt_slot_at=((5, 1), (5, 2), (9, 0)),
                  stall_ticks=(2, 3), crash_at_tick=6)
        jp, tp = jfaults.FaultPlan(**kw), tfaults.FaultPlan(**kw)
        for i in range(10):
            frames = _frames(int(rng.integers(1, 12)), rng)
            a, b = jp.poison_stream(i, frames), tp.poison_stream(i, frames)
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(tfaults.sanitize_frames(b),
                                          jfaults.sanitize_frames(a))
            assert tp.corruptions(i) == jp.corruptions(i)
            assert tp.is_stall(i) == jp.is_stall(i)
        with pytest.raises(tfaults.SimulatedCrash):
            tp.maybe_crash(6)
        tp.maybe_crash(6)                       # one-shot


class TestNoSync:
    """The port's spelling of ``TestZeroSync``: what synchronises with a
    CUDA device is a host read (``Tensor.cpu`` / ``item`` / ``__float__``)
    or an indexed write of a host scalar (``Tensor.__setitem__``, which
    copies the scalar from the host). On the card ``chip_smoke.py`` runs
    the same calls under ``torch.cuda.set_sync_debug_mode("error")``."""

    def _count_reads(self, monkeypatch):
        calls = {"n": 0}
        for name in ("cpu", "item", "__float__", "__setitem__"):
            real = getattr(torch.Tensor, name)

            def counting(self, *a, _real=real, **k):
                calls["n"] += 1
                return _real(self, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counting)
        return calls

    def test_hot_loop_and_snapshots_never_read(self, monkeypatch):
        eng = StubGraphEngine(TORCH.prog(), TTASK, n_streams=2)
        rng = np.random.default_rng(0)
        calls = self._count_reads(monkeypatch)
        eng.open_stream()
        eng.step(rng.standard_normal((2, 8)).astype(np.float32))
        eng.step_many(rng.standard_normal((10, 2, 8)).astype(np.float32))
        eng.snapshot_streams()
        eng.step_many(rng.standard_normal((5, 2, 8)).astype(np.float32))
        eng.rollback_stream(0)
        eng.set_theta_h(0.1)
        tfaults.corrupt_slot_state(eng, 1)
        eng.step(rng.standard_normal((2, 8)).astype(np.float32))
        assert calls["n"] == 0
        _ = eng.stats
        assert calls["n"] == 1

    def test_supervised_tick_reads_only_on_check_ticks(self, monkeypatch):
        eng = StubGraphEngine(TORCH.prog(), TTASK, n_streams=2)
        srv = tres.ResilientStreamServer(tsched.DeltaStreamBatcher(eng),
                                         tres.ResiliencePolicy(check_every=4))
        rng = np.random.default_rng(1)
        for _ in range(2):
            srv.submit(_frames(100, rng))
        srv.tick()
        calls = self._count_reads(monkeypatch)
        for _ in range(3):
            srv.tick()
        assert calls["n"] == 1                  # the check tick's host_carry


class TestSnapshotRollback:
    def test_rollback_restores_state_and_accounting(self):
        got = {}
        for P in PKGS:
            eng = P.Engine(P.prog("fused_q8"), P.task, n_streams=3)
            for _ in range(3):
                eng.open_stream()
            rng = np.random.default_rng(0)
            eng.step_many(rng.standard_normal((8, 3, 8)).astype(np.float32))
            eng.snapshot_streams([1])
            snap = P.carry(eng)
            tail = rng.standard_normal((6, 3, 8)).astype(np.float32)
            out_a = _arr(eng.step_many(tail))
            assert eng.rollback_stream(1) == 8
            host = P.carry(eng)
            for key in ("fired_x", "fired_h", "lat_s", "w_bytes"):
                assert host[key][1] == snap[key][1]
            for key in ("lat_s", "w_bytes"):
                assert host[key][0] != snap[key][0]
            out_b = _arr(eng.step_many(tail))
            np.testing.assert_array_equal(out_b[:, 1], out_a[:, 1])
            got[P.name] = (eng, out_b)
        _close(got["torch"][1], got["jax"][1])
        _same_state(got["jax"][0], got["torch"][0], exact=True)
        _same_report(got["jax"][0].report(), got["torch"][0].report())

    def test_rollback_without_snapshot_rewinds_to_session_start(self):
        for P in PKGS:
            eng = P.Engine(P.prog(), P.task, n_streams=2)
            sid = eng.open_stream()
            xs = np.random.default_rng(1).standard_normal((7, 2, 8)).astype(
                np.float32)
            first = _arr(eng.step_many(xs))
            assert eng.rollback_stream(sid) == 0
            again = _arr(eng.step_many(xs))
            np.testing.assert_array_equal(again[:, sid], first[:, sid])

    def test_rollback_discards_corruption(self):
        for P in PKGS:
            eng = P.Engine(P.prog(), P.task, n_streams=2)
            sid = eng.open_stream()
            rng = np.random.default_rng(2)
            eng.step_many(rng.standard_normal((5, 2, 8)).astype(np.float32))
            eng.snapshot_streams([sid])
            P.faults.corrupt_slot_state(eng, sid)
            eng.step_many(rng.standard_normal((3, 2, 8)).astype(np.float32))
            assert P.carry(eng)["bad_state"][sid] > 0
            eng.rollback_stream(sid)
            for leaf in P.leaves(eng.state.stack):
                assert np.isfinite(leaf).all()
            assert P.carry(eng)["bad_state"][sid] == 0.0

    def test_rollback_requires_open_slot(self):
        eng = StubGraphEngine(TORCH.prog(), TTASK, n_streams=2)
        with pytest.raises(ValueError, match="not open"):
            eng.rollback_stream(0)
        with pytest.raises(ValueError, match="not open"):
            eng.rollback_stream(5)

    def test_lifetime_aggregates_never_rewound(self):
        for P in PKGS:
            eng = P.Engine(P.prog(), P.task, n_streams=2)
            sid = eng.open_stream()
            eng.step_many(np.random.default_rng(3).standard_normal(
                (10, 2, 8)).astype(np.float32))
            agg_before = eng.stats.fired_h
            eng.rollback_stream(sid)
            assert eng.stats.fired_h == agg_before
            assert eng.stats.steps == 10


def _ckpt_paths(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return [leaf["path"] for leaf in json.load(f)["leaves"]]


def _cross_setup(case):
    """``(jax program, port program, jax task, port task, frames fn,
    exact)`` for a cross-package checkpoint case."""
    if case == "rwkv6 fused":
        _, jm, jtask = jrwkv_cfg.reduced_delta_recipe(jax.random.PRNGKey(0))
        tm = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jm),
                                      device="cpu")
        ttask = tmodels.GruTaskConfig(jtask.input_size, jtask.hidden_size,
                                      jtask.num_layers, jtask.output_size)
        d = jtask.input_size

        def frames(t, n, rng):
            return (0.3 * rng.standard_normal((t, n, d))).astype(np.float32)

        return (jcompile(jm, "fused", cell="rwkv6"),
                tcompile(tm, "fused", cell="rwkv6", device="cpu"),
                jtask, ttask, frames, False)
    cell, backend = case.split()
    jprog, tprog = _programs(backend, cell)

    def frames(t, n, rng):
        return rng.standard_normal((t, n, 8)).astype(np.float32)

    return jprog, tprog, JTASK, TTASK, frames, backend != "fused"


class TestEngineCheckpointRestore:
    @pytest.mark.parametrize("backend", ["fused", "fused_q8"])
    def test_restore_is_exact_and_bitwise(self, backend, tmp_path):
        got = {}
        for P in PKGS:
            prog = P.prog(backend)
            eng = P.Engine(prog, P.task, n_streams=3)
            rng = np.random.default_rng(0)
            sid = eng.open_stream()
            eng.step_many(rng.standard_normal((12, 3, 8)).astype(np.float32))
            eng.snapshot_streams()
            eng.checkpoint(str(tmp_path / P.name))
            eng2 = P.Engine.restore(str(tmp_path / P.name), prog, P.task,
                                    n_streams=3)
            assert eng2.report() == eng.report()
            assert eng2._slot_busy == eng._slot_busy
            assert eng2._slot_opened_at == eng._slot_opened_at
            tail = rng.standard_normal((6, 3, 8)).astype(np.float32)
            a = _arr(eng.step_many(tail))
            np.testing.assert_array_equal(a, _arr(eng2.step_many(tail)))
            eng.rollback_stream(sid)
            eng2.rollback_stream(sid)
            b = _arr(eng.step_many(tail))
            np.testing.assert_array_equal(b, _arr(eng2.step_many(tail)))
            assert eng2.report() == eng.report()
            got[P.name] = (eng2, a, b)
        _close(got["torch"][1], got["jax"][1])
        _close(got["torch"][2], got["jax"][2])
        _same_report(got["jax"][0].report(), got["torch"][0].report())
        _same_state(got["jax"][0], got["torch"][0], backend != "fused")
        assert got["torch"][0].graph_stats["captures"] == 1

    def test_restore_carries_resilience_counters(self, tmp_path):
        for P in PKGS:
            eng = P.Engine(P.prog(), P.task)
            frames = _frames(10, np.random.default_rng(1))
            frames[4, :] = np.nan
            eng.step_many(frames)
            eng.checkpoint(str(tmp_path / P.name))
            eng2 = P.Engine.restore(str(tmp_path / P.name), P.prog(), P.task)
            assert eng2.stats.poison_steps == 1.0
            assert eng2.stats.steps == 10

    def test_restore_rejects_wrong_geometry(self, tmp_path):
        eng = StubGraphEngine(TORCH.prog(), TTASK, n_streams=2)
        eng.checkpoint(str(tmp_path))
        with pytest.raises(ValueError, match="logical shape"):
            StubGraphEngine.restore(str(tmp_path), TORCH.prog(), TTASK,
                                    n_streams=4)

    def test_restore_lands_theta_h_in_the_graph_carry(self, tmp_path):
        eng = StubGraphEngine(TORCH.prog("fused_q8"), TTASK)
        eng.set_theta_h(0.4)
        eng.step(np.ones(8, np.float32))
        eng.checkpoint(str(tmp_path))
        eng2 = StubGraphEngine.restore(str(tmp_path), TORCH.prog("fused_q8"),
                                       TTASK)
        ref = StubGraphEngine(TORCH.prog("fused_q8"), TTASK)
        ref.set_theta_h(0.4)
        ref.step(np.ones(8, np.float32))
        xs = _frames(8, np.random.default_rng(5))
        assert torch.equal(eng2.step_many(xs), ref.step_many(xs))
        assert eng2.theta_h == pytest.approx(0.4)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    @pytest.mark.parametrize("case", ["gru fused", "gru fused_q8",
                                      "lstm fused_q4", "rwkv6 fused"])
    def test_checkpoints_restore_across_packages(self, case, writer,
                                                 tmp_path):
        jprog, tprog, jtask, ttask, frames, exact = _cross_setup(case)
        rng = np.random.default_rng(4)
        head, tail = frames(6, 2, rng), frames(10, 2, rng)
        if writer == "jax":
            src = jengine.DeltaStreamEngine(jprog, jtask, n_streams=2)
        else:
            src = StubGraphEngine(tprog, ttask, n_streams=2)
        src.open_stream()
        src.step_many(head)
        src.snapshot_streams()
        src.checkpoint(str(tmp_path / "src"))
        if writer == "jax":
            je, te = src, StubGraphEngine.restore(str(tmp_path / "src"),
                                                  tprog, ttask, n_streams=2)
        else:
            te, je = src, jengine.DeltaStreamEngine.restore(
                str(tmp_path / "src"), jprog, jtask, n_streams=2)
        _same_report(je.report(), te.report())
        assert je._slot_busy == te._slot_busy
        assert je._snap_steps == te._snap_steps
        jo, to = _arr(je.step_many(tail)), _arr(te.step_many(tail))
        scale = max(1.0, float(np.abs(jo).max()))
        np.testing.assert_allclose(to, jo, rtol=0, atol=TOL_F32 * scale)
        for a, b in zip(JAX.leaves(je.state.stack),
                        TORCH.leaves(te.state.stack)):
            if exact:
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=0, atol=TOL_F32 * max(1.0, np.abs(a).max()))
        _same_report(je.report(), te.report())
        je.checkpoint(str(tmp_path / "j"))
        te.checkpoint(str(tmp_path / "t"))
        step = f"step_{te._n_steps:08d}"
        assert (_ckpt_paths(str(tmp_path / "j" / step))
                == _ckpt_paths(str(tmp_path / "t" / step)))


class TestSupervisorPolicies:
    def _srv(self, P, policy, n_streams=2, backend="fused"):
        eng = P.Engine(P.prog(backend), P.task, n_streams=n_streams)
        return P.res.ResilientStreamServer(P.Batcher(eng), policy)

    def _both(self, scenario):
        """Run ``scenario(P)`` in both packages; compare what it returns:
        statuses, counters and reports exactly (R5), outputs within
        TOL_HEAD."""
        jout, tout = scenario(JAX), scenario(TORCH)
        for key in jout:
            if key == "outputs":
                _close(tout[key], jout[key])
            elif key in ("report", "counters"):
                _same_report(jout[key], tout[key])
            else:
                assert tout[key] == jout[key], key
        return tout

    def test_bounded_queue_rejects_with_result(self):
        def run(P):
            srv = self._srv(P, P.res.ResiliencePolicy(max_queue=2))
            rng = np.random.default_rng(0)
            outcomes = [srv.submit(_frames(50, rng)) for _ in range(6)]
            assert [adm for _, adm in outcomes] == [True] * 2 + [False] * 4
            rejected = [r for r in srv.results if r.status == "rejected"]
            assert rejected[0].error["reason"] == "queue_full"
            return {"outcomes": outcomes, "counters": srv.counters,
                    "errors": [r.error for r in rejected]}
        self._both(run)

    def test_deadline_sheds_queued_not_running(self):
        def run(P):
            srv = self._srv(P, P.res.ResiliencePolicy(max_queue=32,
                                                      deadline_ticks=3))
            rng = np.random.default_rng(1)
            running = [srv.submit(_frames(40, rng))[0] for _ in range(2)]
            waiting = [srv.submit(_frames(40, rng))[0] for _ in range(2)]
            shed = []
            for _ in range(10):
                shed += [r for r in srv.tick() if r.status == "shed"]
            assert sorted(r.uid for r in shed) == waiting
            active = [r for r in srv.batcher.slots if r is not None]
            assert sorted(r.uid for r in active) == running
            return {"shed": [(r.uid, r.error) for r in shed],
                    "counters": srv.counters, "report": srv.report()}
        self._both(run)

    def test_quarantine_reject_frees_slot_with_structured_error(self):
        def run(P):
            pol = P.res.ResiliencePolicy(quarantine_after=2,
                                         on_quarantine="reject",
                                         check_every=100)
            srv = self._srv(P, pol)
            rng = np.random.default_rng(2)
            frames = _frames(20, rng)
            frames[2, :] = np.nan
            frames[4, :] = np.nan
            uid, _ = srv.submit(frames)
            good_uid, _ = srv.submit(_frames(20, rng))
            quarantined = []
            while any(r is not None for r in srv.batcher.slots) \
                    or srv.batcher.queue:
                quarantined += [r for r in srv.tick()
                                if r.status == "quarantined"]
            assert [r.uid for r in quarantined] == [uid]
            assert quarantined[0].error["reason"] == "poison_frames"
            ok = [r for r in srv.results if r.status == "ok"]
            assert [r.uid for r in ok] == [good_uid]
            stats = dict(quarantined[0].stats)
            return {"error": quarantined[0].error, "counters": srv.counters,
                    "stats": {k: stats[k] for k in ("stream", "steps",
                                                    "poison_steps",
                                                    "bad_state_steps")},
                    "outputs": _outputs(ok[0]), "report": srv.report()}
        out = self._both(run)
        assert out["counters"]["quarantined"] == 1
        assert out["counters"]["recovered"] == 0

    def test_quarantine_readmit_recovers_bitwise(self):
        def run(P):
            pol = P.res.ResiliencePolicy(quarantine_after=2,
                                         on_quarantine="readmit",
                                         check_every=4)
            srv = self._srv(P, pol, backend="fused_q8")
            frames = _frames(25, np.random.default_rng(3))
            frames[6, :] = np.nan
            frames[11, 0] = np.inf
            uid, _ = srv.submit(frames)
            done = []
            while not done:
                done = [r for r in srv.tick() if r.status == "ok"]
            assert done[0].uid == uid
            assert done[0].error == {"recovered_after_quarantine": True}
            want = _ref_outputs(P, "fused_q8",
                                P.faults.sanitize_frames(frames))
            np.testing.assert_array_equal(_outputs(done[0]), want)
            return {"counters": srv.counters, "outputs": _outputs(done[0]),
                    "report": srv.report()}
        out = self._both(run)
        assert out["counters"]["quarantined"] == out["counters"][
            "recovered"] == 1

    def test_state_corruption_detected_and_recovered(self):
        def run(P):
            pol = P.res.ResiliencePolicy(check_every=4,
                                         on_quarantine="readmit")
            srv = self._srv(P, pol, backend="fused_q8")
            frames = _frames(30, np.random.default_rng(4))
            srv.submit(frames)
            for _ in range(6):
                srv.tick()
            P.faults.corrupt_slot_state(srv.engine, 0)
            done = []
            while not done:
                done = [r for r in srv.tick() if r.status == "ok"]
            np.testing.assert_array_equal(
                _outputs(done[0]), _ref_outputs(P, "fused_q8", frames))
            return {"counters": srv.counters, "outputs": _outputs(done[0]),
                    "report": srv.report()}
        assert self._both(run)["counters"]["quarantined"] == 1

    def test_corruption_escaping_check_cadence_caught_at_harvest(self):
        def run(P):
            pol = P.res.ResiliencePolicy(check_every=10000,
                                         on_quarantine="readmit")
            srv = self._srv(P, pol, backend="fused_q8")
            frames = _frames(12, np.random.default_rng(7))
            uid, _ = srv.submit(frames)
            for _ in range(3):
                srv.tick()
            P.faults.corrupt_slot_state(srv.engine, 0)
            done = []
            while not done:
                done = [r for r in srv.tick() if r.status == "ok"]
            assert done[0].uid == uid
            assert done[0].error == {"recovered_after_quarantine": True}
            np.testing.assert_array_equal(
                _outputs(done[0]), _ref_outputs(P, "fused_q8", frames))
            return {"counters": srv.counters, "outputs": _outputs(done[0]),
                    "report": srv.report()}
        out = self._both(run)
        assert out["counters"]["quarantined"] == out["counters"][
            "recovered"] == 1

    def test_corruption_at_harvest_reject_path(self):
        def run(P):
            pol = P.res.ResiliencePolicy(check_every=10000,
                                         on_quarantine="reject")
            srv = self._srv(P, pol)
            uid, _ = srv.submit(_frames(10, np.random.default_rng(8)))
            for _ in range(2):
                srv.tick()
            P.faults.corrupt_slot_state(srv.engine, 0)
            done = []
            while not done:
                done = [r for r in srv.tick() if r.status == "quarantined"]
            assert done[0].uid == uid
            assert done[0].error["detected_at"] == "harvest"
            return {"error": done[0].error, "counters": srv.counters,
                    "bad": done[0].stats["bad_state_steps"]}
        assert self._both(run)["bad"] > 0

    def test_overload_raises_theta_and_drains_back(self):
        def run(P):
            pol = P.res.ResiliencePolicy(max_queue=256, overload_queue=4,
                                         check_every=2, theta_max=0.5)
            srv = self._srv(P, pol)
            rng = np.random.default_rng(5)
            base = srv.engine.thresholds.theta_h
            for _ in range(30):
                srv.submit(_frames(12, rng))
            thetas = []
            for _ in range(6):
                srv.tick()
                thetas.append(srv.engine.theta_h)
            high = srv.engine.theta_h
            assert high > base
            assert srv.theta_peak == pytest.approx(high, rel=1e-6)
            srv.run_until_drained()
            for _ in range(40):
                srv.tick()
                thetas.append(srv.engine.theta_h)
            assert srv.engine.theta_h == pytest.approx(base, abs=1e-6)
            return {"thetas": thetas, "peak": srv.theta_peak,
                    "counters": srv.counters, "report": srv.report(),
                    "statuses": [(r.uid, r.status) for r in srv.results]}
        assert self._both(run)["counters"]["theta_raises"] >= 1

    def test_overload_requires_exclusive_theta_control(self):
        eng = StubGraphEngine(TORCH.prog(), TTASK, dynamic_target_fired=0.2)
        with pytest.raises(ValueError, match="dynamic"):
            tres.ResilientStreamServer(tsched.DeltaStreamBatcher(eng),
                                       tres.ResiliencePolicy(overload_queue=4))
        pol = TThresholds(theta_x=0.05, per_layer_h=(0.0, 0.4))
        eng2 = StubGraphEngine(TORCH.prog(), TTASK, thresholds=pol)
        with pytest.raises(ValueError, match="per-layer"):
            tres.ResilientStreamServer(tsched.DeltaStreamBatcher(eng2),
                                       tres.ResiliencePolicy(overload_queue=4))
        with pytest.raises(ValueError, match="per-layer"):
            eng2.set_theta_h(0.3)
        with pytest.raises(ValueError, match="on_quarantine"):
            tres.ResilientStreamServer(
                tsched.DeltaStreamBatcher(eng2),
                tres.ResiliencePolicy(on_quarantine="drop"))

    def test_heartbeat_gap_counted(self):
        srv = self._srv(TORCH, tres.ResiliencePolicy(
            heartbeat_deadline_s=0.05))
        srv.submit(_frames(30, np.random.default_rng(6)))
        srv.tick()
        time.sleep(0.2)
        srv.tick()
        assert srv.counters["missed_heartbeats"] >= 1


class TestChaosSoak:
    """The session-churn soak of ``tests/test_resilience.py``: 200
    random-length streams through 8 slots on the q8 tile backend, with
    seeded poison, one slot-state corruption and a mid-soak crash and
    restore, through both packages."""

    N_ARRIVALS = 200
    N_STREAMS = 8

    def _arrivals(self):
        rng = np.random.default_rng(1234)
        arrivals, t = [], 0
        for _ in range(self.N_ARRIVALS):
            arrivals.append((t, _frames(int(rng.integers(5, 30)), rng)))
            t += int(rng.integers(0, 4))
        return arrivals

    def _plan(self, P):
        return P.faults.FaultPlan(seed=99, poison_streams=(17, 90),
                                  inf_streams=(55,), poison_frames=4,
                                  corrupt_slot_at=((40, 3),), stall_ticks=(),
                                  crash_at_tick=120)

    def _run(self, P, ckpt_dir):
        pol = P.res.ResiliencePolicy(max_queue=64, deadline_ticks=60,
                                     quarantine_after=3,
                                     on_quarantine="readmit", check_every=8,
                                     ckpt_dir=ckpt_dir, ckpt_every=32)
        return P.res.serve_resumable(P.prog("fused_q8"), P.task,
                                     self._arrivals(), pol,
                                     n_streams=self.N_STREAMS,
                                     engine_kwargs=P.engine_kw,
                                     fault_plan=self._plan(P))

    def test_churn_soak_chaos_invariant_matches_jax(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setattr(tres, "DeltaStreamEngine", StubGraphEngine)
        results, srv, restarts = self._run(TORCH, str(tmp_path / "a"))
        assert restarts == 1
        assert len(results) == self.N_ARRIVALS
        statuses = {s: sum(1 for r in results.values() if r.status == s)
                    for s in ("ok", "shed", "rejected", "quarantined")}
        assert sum(statuses.values()) == self.N_ARRIVALS
        assert statuses["ok"] >= self.N_ARRIVALS // 2
        assert srv.counters["quarantined"] >= 2
        assert srv.counters["recovered"] == srv.counters["quarantined"]
        assert srv.counters["poison_frames"] > 0
        rep = srv.report()
        assert rep["engine"]["poison_steps"] > 0
        side = tres.load_sidecar(str(tmp_path / "a"))
        assert side is not None and side["tick"] % 32 == 0
        # the restored engine captured its graph once and replayed it
        assert srv.engine.graph_stats["captures"] == 1
        assert srv.engine.graph_stats["replays"] > 0

        # the chaos invariant, bitwise within the port
        plan = self._plan(TORCH)
        ref = StubGraphEngine(TORCH.prog("fused_q8"), TTASK,
                              n_streams=self.N_STREAMS)
        checked = 0
        for i, (_, frames) in enumerate(self._arrivals()):
            r = results[i]
            if r.status != "ok":
                continue
            fed = tfaults.sanitize_frames(plan.poison_stream(i, frames))
            ref.reset()
            sid = ref.open_stream()
            xs = np.zeros((len(fed), self.N_STREAMS, 8), np.float32)
            xs[:, sid] = fed
            want = ref.step_many(xs)[:, sid].numpy()
            np.testing.assert_array_equal(_outputs(r), want,
                                          err_msg=f"arrival {i} diverged")
            checked += 1
        assert checked == statuses["ok"]

        # the JAX package on the same schedule: statuses, counters, Θ peak,
        # restarts and report keys exactly (R5), outputs within TOL_HEAD
        jresults, jsrv, jrestarts = self._run(JAX, str(tmp_path / "j"))
        assert jrestarts == restarts
        assert ({i: r.status for i, r in jresults.items()}
                == {i: r.status for i, r in results.items()})
        assert jsrv.theta_peak == srv.theta_peak
        _same_report(jsrv.report(), rep)
        for i, r in results.items():
            assert r.error == jresults[i].error, i
            if r.status == "ok":
                _close(_outputs(r), _outputs(jresults[i]))
        sides = [load(str(tmp_path / d)) for load, d in (
            (tres.load_sidecar, "a"), (jres.load_sidecar, "j"))]
        for side in sides:
            for key in WALL_KEYS:
                side["counters"].pop(key)
        assert sides[0] == sides[1]

        # determinism: the identical seeded soak reproduces every
        # tick-based counter and status
        results2, srv2, restarts2 = self._run(TORCH, str(tmp_path / "b"))
        assert restarts2 == restarts
        _same_report(srv.report(), srv2.report())
        assert ({i: r.status for i, r in results.items()}
                == {i: r.status for i, r in results2.items()})


class TestServeResumableRestore:
    @pytest.fixture(autouse=True)
    def _stub_engines(self, monkeypatch):
        monkeypatch.setattr(tres, "DeltaStreamEngine", StubGraphEngine)

    def test_no_crash_no_restart(self, tmp_path):
        rng = np.random.default_rng(0)
        arrivals = [(0, _frames(8, rng)) for _ in range(6)]
        for P in PKGS:
            pol = P.res.ResiliencePolicy(ckpt_dir=str(tmp_path / P.name),
                                         ckpt_every=4)
            results, srv, restarts = P.res.serve_resumable(
                P.prog(), P.task, arrivals, pol, n_streams=2,
                engine_kwargs=P.engine_kw)
            assert restarts == 0
            assert all(r.status == "ok" for r in results.values())
            assert len(results) == 6

    def test_crash_without_checkpoint_dir_replays_all(self):
        rng = np.random.default_rng(1)
        arrivals = [(0, _frames(8, rng)) for _ in range(4)]
        got = {}
        for P in PKGS:
            results, srv, restarts = P.res.serve_resumable(
                P.prog(), P.task, arrivals, P.res.ResiliencePolicy(),
                n_streams=2, engine_kwargs=P.engine_kw,
                fault_plan=P.faults.FaultPlan(crash_at_tick=5))
            assert restarts == 1
            assert all(r.status == "ok" for r in results.values())
            got[P.name] = results
        for i, r in got["torch"].items():
            _close(_outputs(r), _outputs(got["jax"][i]))

    def test_crash_budget_exhaustion_propagates(self, tmp_path):
        rng = np.random.default_rng(2)
        arrivals = [(0, _frames(30, rng)) for _ in range(4)]

        class AlwaysCrash(tfaults.FaultPlan):
            def maybe_crash(self, tick):
                if tick == 5:
                    raise tfaults.SimulatedCrash("hard fault, every time")
        pol = tres.ResiliencePolicy(max_restarts=2, ckpt_dir=str(tmp_path))
        with pytest.raises(tfaults.SimulatedCrash):
            tres.serve_resumable(TORCH.prog(), TTASK, arrivals, pol,
                                 n_streams=2, engine_kwargs={"device": "cpu"},
                                 fault_plan=AlwaysCrash())

    def test_default_engine_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(tres, "DeltaStreamEngine",
                            tengine.DeltaStreamEngine)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tres.serve_resumable(TORCH.prog(), TTASK, [],
                                 tres.ResiliencePolicy(), n_streams=2)


class TestBufferIdentity:
    """Every replay of the captured step sees the buffers of the capture,
    through restore, corruption, rollback, an overload Θ write and a whole
    resumable soak; and the stub catches an engine that rebinds."""

    def test_every_replay_sees_the_captured_buffers(self, tmp_path,
                                                    monkeypatch):
        prog = TORCH.prog("fused_q8")
        eng = StubGraphEngine(prog, TTASK, n_streams=3)
        rng = np.random.default_rng(0)
        sid = eng.open_stream()
        eng.step_many(rng.standard_normal((5, 3, 8)).astype(np.float32))
        eng.snapshot_streams()
        eng.checkpoint(str(tmp_path / "e"))
        back = StubGraphEngine.restore(str(tmp_path / "e"), prog, TTASK,
                                       n_streams=3)
        for e in (eng, back):
            ptrs = buffer_ptrs(e)
            tfaults.corrupt_slot_state(e, sid)
            e.step(rng.standard_normal((3, 8)).astype(np.float32))
            assert e.host_carry()["bad_state"][sid] == 1.0
            e.rollback_stream(sid)
            e.set_theta_h(0.3)
            e.step_many(rng.standard_normal((4, 3, 8)).astype(np.float32))
            e.reset()
            e.step(rng.standard_normal((3, 8)).astype(np.float32))
            assert buffer_ptrs(e) == ptrs
            assert e.graph_stats["captures"] == 1

        engines = []

        class Recording(StubGraphEngine):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                engines.append((self, buffer_ptrs(self)))
        monkeypatch.setattr(tres, "DeltaStreamEngine", Recording)
        arrivals = [(2 * i, _frames(int(n), rng))
                    for i, n in enumerate(rng.integers(4, 12, 24))]
        plan = tfaults.FaultPlan(seed=3, poison_streams=(2, 9),
                                 poison_frames=3, corrupt_slot_at=((9, 1),),
                                 crash_at_tick=20)
        pol = tres.ResiliencePolicy(check_every=4, quarantine_after=2,
                                    overload_queue=2, ckpt_dir=str(
                                        tmp_path / "s"), ckpt_every=8)
        results, srv, restarts = tres.serve_resumable(
            prog, TTASK, arrivals, pol, n_streams=3,
            engine_kwargs={"device": "cpu"}, fault_plan=plan)
        assert restarts == 1 and len(engines) == 2
        assert all(r.status == "ok" for r in results.values())
        assert srv.counters["quarantined"] >= 1
        for e, ptrs in engines:
            assert buffer_ptrs(e) == ptrs
            assert e.graph_stats["captures"] == 1
            assert e.graph_stats["replays"] > 0

    @pytest.mark.parametrize("where", ["restore", "corrupt_slot_state"])
    def test_the_stub_catches_a_rebinding_engine(self, where, tmp_path):
        # the JAX package's spelling (assign a new tree to engine.state)
        # silently steps the old buffer on the card; the stub refuses it
        prog = TORCH.prog()
        eng = StubGraphEngine(prog, TTASK, n_streams=2)
        eng.step(np.ones((2, 8), np.float32))
        if where == "restore":
            eng.checkpoint(str(tmp_path))
            eng = StubGraphEngine.restore(str(tmp_path), prog, TTASK,
                                          n_streams=2)
            eng.state = tengine._clone(eng.state)
        else:
            state = tengine._clone(eng.state)
            for leaf in tengine._leaves(state.stack):
                leaf[0] = float("nan")
            eng.state = state
        with pytest.raises(AssertionError, match="rebound"):
            eng.step(np.ones((2, 8), np.float32))
