"""The compiled train steps (``repro_torch.train.trainer.CompiledTrainStep``:
``make_gru_train_step``, ``make_lm_train_step`` and the launcher's step),
on the CPU, through a stub of the graph capture, against the port's eager
step and the JAX package's jitted steps.

On a CUDA device a compiled step captures one step over fixed state and
batch buffers and replays it; on the CPU it runs eagerly. Here
``trainer._capture_for`` hands out ``train_stub``, which records the
pointers of the state and batch buffers at capture and fails a replay
after one moved (a CUDA graph would step the old buffers), and whose
replay reruns the captured body and copies its metric vectors into
tensors that every replay overwrites, as a graph's static outputs are.

Held: the stub-compiled steps bitwise the eager step (``.eager``, the
un-compiled step) over three steps from copies of one state, in the loss,
every metric, the parameters, both moments and the step count; against
JAX's jitted steps, each step's loss within 1e-4 relative (the bound of
``test_torch_train.py`` / ``test_torch_lm_train_loop.py``'s
``train_loop`` histories: Adam steps that are near-sign updates of
gradients that agree to ~1e-6). Then the buffers' contract: donation,
copies, metrics kept, recapture keys, and no capture on the CPU.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gru_rnn as jmodels
from repro.quant import qat as jqat
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.dist.elastic import best_mesh
from repro_torch.dist.sharding import AxisRules, use_mesh
from repro_torch.models import gru_rnn as tmodels
from repro_torch.quant import qat as tqat
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer
from test_torch_lm_train import _jb, _model, _opt, _tb
from test_torch_train import LR, _batch, _port_task, _t, _task

torch.set_num_threads(1)

STEPS = 3
TOL_LOSS = 1e-4
GRU_CASES = [("ctc", "FP32", 0.0), ("ctc", "EDGEDRNN_QAT", 0.25),
             ("regression", "FP32", 0.0)]
LM_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "rwkv6-1.6b")


def _buffers(step) -> list:
    return toptim.tree_leaves(step._state) + list(step._batch.values())


def train_stub(body):
    """A stand-in for ``ops.capture_cuda_graph`` for a compiled train step
    on the CPU (module docstring)."""
    step = inspect.getclosurevars(body).nonlocals["self"]
    held = [t.data_ptr() for t in _buffers(step)]
    static = []

    def replay():
        assert [t.data_ptr() for t in _buffers(step)] == held, (
            "a state or batch buffer was rebound after the capture; the "
            "graph would step the old one")
        outs = body()
        if not static:
            static.extend(torch.empty_like(o) for o in outs)
        for s, o in zip(static, outs):
            s.copy_(o)
        return static

    return replay


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(ttrainer, "_capture_for", lambda device: train_stub)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else
                  torch.int32) if t.is_floating_point() else t


def _same_state(a, b) -> bool:
    la, lb = toptim.tree_leaves(a), toptim.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _run(step, state, batches):
    """``len(batches)`` steps; returns the final state and each step's
    metrics as floats."""
    hist = []
    for b in batches:
        state, m = step(state, b)
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


def _against_eager(step, state, batches):
    """The compiled ``step`` and its eager twin from copies of ``state``:
    bitwise in every metric and in the final state. Returns the compiled
    run's metrics."""
    twin = toptim.tree_map(torch.clone, state)
    s1, h1 = _run(step, state, batches)
    s0, h0 = _run(step.eager, twin, batches)
    assert h1 == h0                      # every metric, exactly
    assert _same_state(s1, s0)
    assert int(s1.step) == len(batches)
    return h1


# -- the paper's GRU step ------------------------------------------------------

@pytest.mark.parametrize("kind,qat,theta", GRU_CASES)
def test_compiled_gru_step_is_the_eager_step_and_near_jax(stubbed, kind, qat,
                                                          theta):
    cfg = _task(kind, theta)
    jp = jmodels.init_gru_model(jax.random.PRNGKey(0), cfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    batches = [_batch(cfg, t=24, b=4, seed=s) for s in range(STEPS)]
    tstep = ttrainer.make_gru_train_step(
        _port_task(cfg),
        toptim.AdamConfig(schedule=toptim.constant_schedule(LR)),
        qat=getattr(tqat, qat))
    hist = _against_eager(tstep, ttrainer.init_train_state(tp),
                          [{k: _t(v) for k, v in b.items()} for b in batches])
    assert tstep.stats["captures"] == 1
    assert tstep.stats["replays"] == STEPS
    jstep = jtrainer.make_gru_train_step(
        cfg, joptim.AdamConfig(schedule=joptim.constant_schedule(LR)),
        qat=getattr(jqat, qat))
    js = jtrainer.init_train_state(jp)
    for b, h in zip(batches, hist):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        assert sorted(jm) == sorted(h)
        np.testing.assert_allclose(h["loss"], float(jm["loss"]),
                                   rtol=TOL_LOSS)


# -- the LM step ---------------------------------------------------------------

def _lm_batches(jcfg, n, b=4, s=16):
    rng = np.random.default_rng(11)
    return [{"tokens": rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


def _near_jax(jstep, jp, batches, hist):
    js = jtrainer.init_train_state(jp)
    for b, h in zip(batches, hist):
        js, jm = jstep(js, _jb(b))
        assert sorted(jm) == sorted(h)
        np.testing.assert_allclose(h["loss"], float(jm["loss"]),
                                   rtol=TOL_LOSS)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_compiled_lm_step_is_the_eager_step_and_near_jax(stubbed, arch):
    jcfg, tcfg, jp, tp, _ = _model(arch)
    assert tcfg.n_layers == 2
    batches = _lm_batches(jcfg, STEPS)
    tstep = ttrainer.make_lm_train_step(tcfg, _opt(toptim))
    assert tstep.donate
    hist = _against_eager(tstep, ttrainer.init_train_state(tp),
                          [_tb(b) for b in batches])
    assert tstep.stats == {"captures": 1, "replays": STEPS,
                           "capture_s": tstep.stats["capture_s"]}
    _near_jax(jtrainer.make_lm_train_step(jcfg, _opt(joptim), donate=False),
              jp, batches, hist)


def test_compiled_grad_accum_step_is_the_eager_step_and_near_jax(stubbed):
    jcfg, tcfg, jp, tp, _ = _model("llama3.2-1b")
    batches = _lm_batches(jcfg, STEPS)
    tstep = ttrainer.CompiledTrainStep(
        ttrainer.make_lm_train_step_fn(tcfg, _opt(toptim), grad_accum=2),
        donate=True)
    hist = _against_eager(tstep, ttrainer.init_train_state(tp),
                          [_tb(b) for b in batches])
    assert tstep.stats["captures"] == 1
    _near_jax(jax.jit(jtrainer.make_lm_train_step_fn(jcfg, _opt(joptim),
                                                     grad_accum=2)),
              jp, batches, hist)


# -- the buffers' contract -----------------------------------------------------

def _small_gru():
    cfg = _task("regression", 0.0, h=16)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(
        np.asarray, jmodels.init_gru_model(jax.random.PRNGKey(1), cfg)),
        device="cpu")
    batches = [{k: _t(v) for k, v in _batch(cfg, t=8, b=3, seed=s).items()}
               for s in range(4)]
    opt = toptim.AdamConfig(schedule=toptim.constant_schedule(LR))
    return _port_task(cfg), opt, ttrainer.init_train_state(tp), batches


def test_without_donation_the_callers_state_stays_as_it_was(stubbed):
    task, opt, state, batches = _small_gru()
    step = ttrainer.make_gru_train_step(task, opt)
    assert not step.donate
    kept = toptim.tree_map(torch.clone, state)
    new, _ = step(state, batches[0])
    assert _same_state(state, kept)
    own = toptim.tree_leaves(step._state)
    assert not any(a is b for a, b in zip(toptim.tree_leaves(new), own))
    assert not any(a is b for a, b in zip(toptim.tree_leaves(state), own))
    newer, _ = step(new, batches[1])
    assert int(new.step) == 1 and int(newer.step) == 2       # a copy each


def test_with_donation_the_step_returns_its_buffers(stubbed):
    jcfg, tcfg, _, tp, _ = _model("llama3.2-1b")
    b = [_tb(x) for x in _lm_batches(jcfg, 3)]
    step = ttrainer.make_lm_train_step(tcfg, _opt(toptim))
    state = ttrainer.init_train_state(tp)
    before = toptim.tree_map(torch.clone, state)
    s1, _ = step(state, b[0])
    own = toptim.tree_leaves(step._state)
    assert all(x is y for x, y in zip(toptim.tree_leaves(s1), own))
    # the state handed in became the buffers (no copy) and was updated
    assert all(x is y for x, y in zip(toptim.tree_leaves(state), own))
    assert not _same_state(state, before) and int(state.step) == 1
    s2, _ = step(s1, b[1])
    assert all(x is y for x, y in zip(toptim.tree_leaves(s2), own))
    assert int(s1.step) == 2                    # the same tensors, in place
    # a state that is not the graph's own is copied into the buffers
    s3, _ = step(before, b[2])
    assert int(s3.step) == 1 and int(before.step) == 0
    assert step.stats["captures"] == 1


def test_earlier_metrics_survive_later_calls(stubbed):
    task, opt, state, batches = _small_gru()
    step = ttrainer.make_gru_train_step(task, opt)
    state, m1 = step(state, batches[0])
    first = {k: float(v) for k, v in m1.items()}
    for b in batches[1:]:
        state, m = step(state, b)
    assert {k: float(v) for k, v in m1.items()} == first
    assert float(m["loss"]) != first["loss"]


def test_a_changed_batch_shape_or_mesh_recaptures(stubbed):
    task, opt, state, batches = _small_gru()
    step = ttrainer.make_gru_train_step(task, opt)
    state, _ = step(state, batches[0])
    state, _ = step(state, batches[1])
    assert step.stats["captures"] == 1
    longer = {k: torch.cat([v, v]) for k, v in batches[2].items()}
    state, _ = step(state, longer)
    assert step.stats["captures"] == 2
    state, _ = step(state, longer)
    assert step.stats["captures"] == 2
    mesh = best_mesh(model_parallel=1, devices=[torch.device("cpu")])
    with use_mesh(mesh, AxisRules()):
        state, _ = step(state, longer)
        assert step.stats["captures"] == 3
        state, _ = step(state, longer)
        assert step.stats["captures"] == 3
    state, _ = step(state, longer)
    assert step.stats["captures"] == 4
    assert step.stats["replays"] == 7


def test_a_changed_determinism_switch_recaptures(stubbed):
    task, opt, state, batches = _small_gru()
    step = ttrainer.make_gru_train_step(task, opt)
    state, _ = step(state, batches[0])
    torch.use_deterministic_algorithms(True)
    try:
        state, _ = step(state, batches[1])
    finally:
        torch.use_deterministic_algorithms(False)
    assert step.stats["captures"] == 2


def test_a_step_that_does_not_update_its_buffers_is_refused(stubbed):
    """The graph steps the state only through ``adam_update`` in place: a
    step that returns new tensors would leave the buffers as they were."""
    task, opt, state, batches = _small_gru()
    inner = ttrainer.make_gru_train_step(task, opt).eager

    def copying(st, b):
        new, m = inner(st, b)
        return toptim.tree_map(torch.clone, new), m
    step = ttrainer.CompiledTrainStep(copying)
    with pytest.raises(RuntimeError, match="not its buffers"):
        step(state, batches[0])


def test_the_stub_fails_a_replay_over_a_moved_buffer(stubbed):
    task, opt, state, batches = _small_gru()
    step = ttrainer.make_gru_train_step(task, opt)
    state, _ = step(state, batches[0])
    step._batch["features"] = step._batch["features"].clone()
    with pytest.raises(AssertionError, match="rebound"):
        step(state, batches[1])


def test_the_cpu_path_captures_nothing():
    task, opt, state, batches = _small_gru()
    step = ttrainer.make_gru_train_step(task, opt)
    twin = toptim.tree_map(torch.clone, state)
    s1, h1 = _run(step, state, batches)
    s0, h0 = _run(step.eager, twin, batches)
    assert h1 == h0 and _same_state(s1, s0)
    assert step.stats["captures"] == 0 and step.stats["replays"] == 0
    assert step._graph is None and step._state is None


def test_the_launchers_step_is_compiled_with_donation(stubbed, monkeypatch):
    """``launch.train`` through the stub capture: one capture, a replay a
    step, and the losses of the same run with the step eager, bitwise."""
    from repro_torch.launch import train as launch_train
    made = []
    orig = ttrainer.CompiledTrainStep

    def spy(step, donate=False):
        made.append(orig(step, donate))
        return made[-1]
    monkeypatch.setattr(launch_train, "CompiledTrainStep", spy)
    argv = ["--arch", "llama3.2-1b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "16", "--grad-accum", "2", "--device", "cpu"]
    out = launch_train.main(argv)
    assert len(made) == 1 and made[0].donate
    assert made[0].stats["captures"] == 1 and made[0].stats["replays"] == 3
    monkeypatch.setattr(ttrainer, "_capture_for", lambda device: None)
    eager = launch_train.main(argv)
    assert made[1].stats["captures"] == 0
    assert out["losses"] == eager["losses"]
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_label_gather_has_the_gather_gradient(seed):
    """The CTC loss's label columns (``ctc._LabelColumns``): the forward is
    the gather's, bitwise; the backward sums the repeated blank column's
    gradients in a fixed order (on a GPU gather's backward adds them with
    atomics, in an order that changes from run to run), within float32
    sum-order rounding of gather's own backward."""
    from repro_torch.train import ctc as tctc
    rng = np.random.default_rng(seed)
    t, b, c, s = 7, 3, 12, 9
    lp = torch.from_numpy(rng.normal(0, 1, (t, b, c)).astype(np.float32))
    ext = torch.from_numpy(rng.integers(0, c, (b, s)))
    ext[:, ::2] = 0                                  # the blanks
    cot = torch.from_numpy(rng.normal(0, 1, (t, b, s)).astype(np.float32))
    a = lp.clone().requires_grad_(True)
    ya = tctc._LabelColumns.apply(a, ext)
    ya.backward(cot)
    g = lp.clone().requires_grad_(True)
    yg = torch.gather(g, 2, ext.expand(t, -1, -1))
    yg.backward(cot)
    assert torch.equal(ya, yg)
    np.testing.assert_allclose(a.grad.numpy(), g.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
