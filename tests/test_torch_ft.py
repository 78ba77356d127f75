"""The port's fault-tolerance substrate (``repro_torch/ft``) against the JAX
package's (``repro/ft``), on the CPU: the checkpoint format, read and
written by both packages; heartbeat and straggler detection; and
crash-consistent restart of a loop of steps.

Checkpoints: the manifests two packages write for one tree are equal leaf
for leaf (path, file, shape, dtype, checksum), and each restores the
other's exactly. Heartbeat, straggler and restart run the same inputs
through both packages and give the same outcomes; a resumed loop is
bitwise equal to an uninterrupted one, and within 1e-6 of the JAX loop (a
small matmul each step, one library each).
"""
import glob
import json
import os
import threading
from dataclasses import asdict
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as jprogram
from repro.ft import checkpoint as jck
from repro.ft import restart as jrestart
from repro.ft.heartbeat import HeartbeatMonitor as JHeartbeat
from repro.ft.straggler import StragglerDetector as JStraggler
from repro.models import gru_rnn as jmodels
from repro_torch.core import program as tprogram
from repro_torch.ft import checkpoint as tck
from repro_torch.ft import restart as trestart
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.models import gru_rnn as tmodels

torch.set_num_threads(1)


class Pair(NamedTuple):
    first: object
    second: object


def _trees():
    """The same mixed tree in both packages: dict (unsorted keys), list,
    tuple, NamedTuple and program-state nodes, several dtypes."""
    rng = np.random.default_rng(0)
    leaves = {"f": rng.standard_normal((3, 4)).astype(np.float32),
              "i8": rng.integers(-128, 127, (5,)).astype(np.int8),
              "b": rng.random((2, 2)) < 0.5,
              "i32": np.arange(4, dtype=np.int32),
              "i64": np.arange(4, dtype=np.int64),
              "s": np.float32(2.5)}
    cfg = jmodels.GruTaskConfig(8, 16, 2, 3)
    jp = jmodels.init_gru_model(jax.random.PRNGKey(0), cfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    jstate = jprogram.compile_deltagru(jp, "fused").init_state((2,))
    tstate = tprogram.compile_deltagru(tp, "fused",
                                       device="cpu").init_state((2,))

    def build(arr, state):
        return {"zeta": [arr(leaves["f"]), (arr(leaves["i8"]),)],
                "alpha": Pair(arr(leaves["b"]), {"y": arr(leaves["s"]),
                                                 "x": arr(leaves["i32"])}),
                "state": state, "host": leaves["i64"][:2]}

    return (build(jnp.asarray, jstate),
            build(lambda a: torch.from_numpy(np.array(a)), tstate))


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _same_leaves(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [leaf for _, leaf in tck.tree_paths(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        # JAX's restore narrows an int64 host leaf to int32 (no x64 mode)
        assert a.dtype == b.dtype or (a.dtype, b.dtype) == (np.int32,
                                                             np.int64)
        np.testing.assert_array_equal(a, b)


class TestTreePaths:
    def test_paths_spelled_as_jax_spells_them(self):
        jtree, ttree = _trees()
        jpaths, _, _ = jck._tree_paths(jtree)
        tpaths = [p for p, _ in tck.tree_paths(ttree)]
        assert tpaths == jpaths
        assert "state/0/.layers/1/.x_mem/.memory" in tpaths
        assert tpaths[:2] == ["alpha/.first", "alpha/.second/x"]

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_manifests_equal_and_restore_across(self, writer, tmp_path):
        jtree, ttree = _trees()
        jck.save(str(tmp_path / "j"), 3, jtree)
        tck.save(str(tmp_path / "t"), 3, ttree)
        jm = _manifest(str(tmp_path / "j" / "step_00000003"))
        tm = _manifest(str(tmp_path / "t" / "step_00000003"))
        assert jm == tm
        src = str(tmp_path / ("j" if writer == "jax" else "t"))
        _same_leaves(jck.restore(src, jtree), tck.restore(src, ttree,
                                                          device="cpu"))
        got = tck.restore(src, ttree, device="cpu")
        assert isinstance(got["state"], tprogram.DeltaProgramState)
        assert isinstance(got["alpha"], Pair)
        assert isinstance(got["host"], np.ndarray)
        assert list(got) == list(ttree)

    def test_jax_restore_narrows_int64_host_leaves(self, tmp_path):
        # a fact about the reference: JAX's restore device_puts every leaf,
        # and without x64 an int64 host leaf comes back as int32; the port
        # keeps a host leaf on the host in its own dtype
        host = {"n": np.arange(3, dtype=np.int64)}
        jck.save(str(tmp_path), 1, host)
        assert np.asarray(jck.restore(str(tmp_path), host)["n"]).dtype == \
            np.int32
        got = tck.restore(str(tmp_path), host, device="cpu")["n"]
        assert got.dtype == np.int64 and got.tolist() == [0, 1, 2]

    def test_missing_path_raises_key_error(self, tmp_path):
        tck.save(str(tmp_path), 1, {"w": torch.zeros(2)})
        with pytest.raises(KeyError):
            tck.restore(str(tmp_path), {"v": torch.zeros(2)}, device="cpu")


class TestCheckpoint:
    def test_roundtrip_and_integrity(self, tmp_path):
        state = {"a": torch.arange(12.0).reshape(3, 4),
                 "nested": {"b": torch.ones((5,), dtype=torch.int32)}}
        tck.save(str(tmp_path), 7, state)
        restored = tck.restore(str(tmp_path), state, device="cpu")
        assert torch.equal(restored["a"], state["a"])
        assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
        assert restored["nested"]["b"].dtype == torch.int32
        assert tck.latest_step(str(tmp_path)) == 7

    def test_async_save_publishes_atomically(self, tmp_path):
        state = {"w": torch.zeros((1000, 100))}
        ev = threading.Event()
        tck.save(str(tmp_path), 1, state, async_write=True, _done_event=ev)
        assert ev.wait(30)
        assert tck.latest_step(str(tmp_path)) == 1

    def test_async_save_snapshots_the_call_time_state(self, tmp_path):
        # the engine's buffers are written in place after a checkpoint: the
        # background write must hold the values of the call
        buf = torch.zeros(64)
        gate, ev = threading.Event(), threading.Event()
        real = tck.np.save

        def slow_save(*a, **k):
            gate.wait(30)
            return real(*a, **k)
        try:
            tck.np.save = slow_save
            tck.save(str(tmp_path), 1, {"w": buf}, async_write=True,
                     _done_event=ev)
            buf.fill_(5.0)
            gate.set()
            assert ev.wait(30)
        finally:
            tck.np.save = real
        got = tck.restore(str(tmp_path), {"w": buf}, device="cpu")
        assert torch.equal(got["w"], torch.zeros(64))

    def test_corruption_detected(self, tmp_path):
        state = {"w": torch.ones((8,))}
        path = tck.save(str(tmp_path), 3, state)
        fn = glob.glob(os.path.join(path, "arr_*.npy"))[0]
        arr = np.load(fn)
        arr[0] = 999.0
        np.save(fn, arr)
        with pytest.raises(IOError):
            tck.restore(str(tmp_path), state, device="cpu")

    def test_restore_places_tensors_on_the_device_asked(self, tmp_path,
                                                        monkeypatch):
        state = {"w": torch.arange(8.0).reshape(2, 4)}
        tck.save(str(tmp_path), 1, state)
        got = tck.restore(str(tmp_path), state, device="cpu")
        assert got["w"].device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.restore(str(tmp_path), state)

    def test_manager_retention(self, tmp_path):
        mgr = tck.CheckpointManager(str(tmp_path), every=1, keep=2,
                                    async_write=False)
        for s in range(1, 6):
            mgr.maybe_save(s, {"w": torch.full((2,), float(s))})
        steps = sorted(int(d.split("_")[-1]) for d in os.listdir(tmp_path)
                       if d.startswith("step_"))
        assert steps == [4, 5]

    def test_restore_casts_to_target_dtype(self, tmp_path):
        state = {"w": torch.arange(32.0).reshape(8, 4) / 3}   # fp32 save
        tck.save(str(tmp_path), 1, state)
        for dtype in (torch.bfloat16, torch.int8, torch.float64):
            target = {"w": torch.zeros((8, 4), dtype=dtype)}
            got = tck.restore(str(tmp_path), target, device="cpu")
            assert got["w"].dtype == dtype
            assert torch.equal(got["w"], state["w"].to(dtype))
        got = tck.restore(str(tmp_path), {"w": np.zeros((8, 4), np.int64)},
                          device="cpu")
        assert got["w"].dtype == np.int64

    def test_restore_shape_mismatch_raises(self, tmp_path):
        tck.save(str(tmp_path), 1, {"w": torch.zeros((4, 4))})
        with pytest.raises(ValueError, match="logical shape"):
            tck.restore(str(tmp_path), {"w": torch.zeros((2, 4))},
                        device="cpu")

    def test_manager_wait_reraises_background_write_failure(self, tmp_path,
                                                            monkeypatch):
        mgr = tck.CheckpointManager(str(tmp_path), every=1, keep=2,
                                    async_write=True)
        boom = IOError("disk full")

        def failing_save(*a, **k):
            raise boom
        monkeypatch.setattr(tck.np, "save", failing_save)
        assert mgr.maybe_save(1, {"w": torch.ones((4,))})
        with pytest.raises(IOError, match="disk full"):
            mgr.wait(timeout=30)
        assert mgr.wait(timeout=1)

    def test_manager_wait_times_out_on_hung_write(self, tmp_path,
                                                  monkeypatch):
        gate = threading.Event()
        real_save = tck.np.save

        def slow_save(*a, **k):
            gate.wait(30)
            return real_save(*a, **k)
        monkeypatch.setattr(tck.np, "save", slow_save)
        mgr = tck.CheckpointManager(str(tmp_path), every=1,
                                    async_write=True)
        mgr.maybe_save(1, {"w": torch.ones((2,))})
        assert mgr.wait(timeout=0.2) is False
        gate.set()
        assert mgr.wait(timeout=30) is True
        assert tck.latest_step(str(tmp_path)) == 1


class TestHeartbeatStraggler:
    @pytest.mark.parametrize("cls", [HeartbeatMonitor, JHeartbeat])
    def test_heartbeat_detects_dead_worker(self, cls):
        clock = [0.0]
        mon = cls(deadline_s=5.0, clock=lambda: clock[0])
        mon.register("w0")
        mon.register("w1")
        mon.beat("w0")
        mon.beat("w1")
        clock[0] = 3.0
        mon.beat("w0")
        assert mon.age("w1") == 3.0
        clock[0] = 7.0
        assert mon.dead_workers() == ["w1"]
        assert not mon.all_alive

    @pytest.mark.parametrize("cls", [StragglerDetector, JStraggler])
    def test_straggler_patience_and_policy(self, cls):
        det = cls(factor=2.0, patience=2, policy="drop")
        fleet = {f"w{i}": 1.0 for i in range(8)}
        r = det.observe({**fleet, "w7": 10.0})
        assert r.stragglers == []
        r = det.observe({**fleet, "w7": 10.0})
        assert r.stragglers == ["w7"] and r.action == "drop"
        assert det.rescale_factor(8, 1) == pytest.approx(8 / 7)

    @pytest.mark.parametrize("cls", [StragglerDetector, JStraggler])
    def test_straggler_recovers(self, cls):
        det = cls(factor=2.0, patience=2, ewma=1.0)
        fleet = {f"w{i}": 1.0 for i in range(4)}
        det.observe({**fleet, "w3": 10.0})
        r = det.observe(fleet)
        assert r.stragglers == []

    def test_same_reports_as_jax_on_a_step_time_trace(self):
        rng = np.random.default_rng(3)
        ours, ref = StragglerDetector(patience=3), JStraggler(patience=3)
        for t in range(60):
            times = {f"w{i}": float(rng.gamma(4.0, 0.25)) for i in range(6)}
            if 20 <= t < 35:
                times["w2"] *= 6.0
            assert asdict(ours.observe(times)) == asdict(ref.observe(times))
            best = min(times.values())
            assert (asdict(ours.observe_solo("serve", times["w0"], best))
                    == asdict(ref.observe_solo("serve", times["w0"], best)))


def _batches(start):
    def gen():
        i = start
        while True:
            rng = np.random.default_rng(1000 + i)
            x = rng.standard_normal((16, 5)).astype(np.float32)
            y = (x @ np.linspace(-1, 1, 15).reshape(5, 3)).astype(np.float32)
            yield x, y
            i += 1
    return gen()


def _sgd(lib):
    """One step of least squares, the same ops in either library."""
    def step(state, batch):
        x, y = (lib.asarray(b) for b in batch)
        w, b = state["params"]
        err = x @ w + b - y
        gw = x.T @ err * (2.0 / x.shape[0])
        gb = lib.sum(err, 0) * (2.0 / x.shape[0])
        new = {"params": (w - 0.05 * gw, b - 0.05 * gb),
               "step": state["step"] + 1}
        return new, {"loss": lib.mean(err * err)}
    return step


class _TorchLib:
    asarray = staticmethod(torch.as_tensor)
    sum = staticmethod(torch.sum)
    mean = staticmethod(torch.mean)


class TestRestart:
    def test_crash_resume_is_bitwise_identical(self, tmp_path):
        """12 steps with a crash at step 7: the resumed loop ends where an
        uninterrupted loop does, bit for bit, and where the JAX package's
        resumed loop does, within 1e-6."""
        w0 = np.random.default_rng(0).standard_normal((5, 3)).astype(
            np.float32)

        def make_state():
            return {"params": (torch.from_numpy(w0.copy()), torch.zeros(3)),
                    "step": torch.tensor(0)}

        def make_jstate():
            return {"params": (jnp.asarray(w0), jnp.zeros(3)),
                    "step": jnp.asarray(0)}

        step_fn, jstep_fn = _sgd(_TorchLib), _sgd(jnp)
        state, it = make_state(), _batches(0)
        for _ in range(12):
            state, _ = step_fn(state, next(it))

        def crashing(fn):
            armed = {"on": True}

            def step(state, batch):
                if armed["on"] and int(state["step"]) == 7:
                    armed["on"] = False
                    raise RuntimeError("simulated node failure")
                return fn(state, batch)
            return step

        got, hist, restarts = trestart.run_resumable(
            make_state, crashing(step_fn), _batches, 12,
            trestart.RestartPolicy(max_restarts=2,
                                   ckpt_dir=str(tmp_path / "t"),
                                   save_every=5), device="cpu")
        jgot, jhist, jrestarts = jrestart.run_resumable(
            make_jstate, crashing(jstep_fn), _batches, 12,
            jrestart.RestartPolicy(max_restarts=2,
                                   ckpt_dir=str(tmp_path / "j"),
                                   save_every=5))
        assert restarts == jrestarts == 1
        assert int(got["step"]) == 12 and len(hist) == len(jhist) == 12
        for a, b in zip(state["params"], got["params"]):
            assert torch.equal(a, b)
        for a, b in zip(jgot["params"], got["params"]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
        for h, jh in zip(hist, jhist):
            assert h["loss"] == pytest.approx(jh["loss"], rel=1e-6)

    def test_with_restarts_budget_and_callback(self):
        seen = []

        def body():
            if len(seen) < 2:
                raise ValueError("transient")
            return "done"
        assert trestart.with_restarts(body, 3, on_restart=seen.append) == (
            "done", 2)
        with pytest.raises(ValueError):
            trestart.with_restarts(lambda: (_ for _ in ()).throw(
                ValueError("hard")), 1)
        with pytest.raises(KeyError):
            trestart.with_restarts(lambda: {}["x"], 3,
                                   retryable=(ValueError,))

    def test_default_checkpoint_dir_is_under_the_temp_dir(self, tmp_path,
                                                          monkeypatch):
        monkeypatch.setenv("TMPDIR", str(tmp_path))
        monkeypatch.setattr(trestart.tempfile, "tempdir", None)
        assert trestart.RestartPolicy().ckpt_dir.startswith(str(tmp_path))
