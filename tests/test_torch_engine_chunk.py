"""``DeltaStreamEngine.step_many`` over a chunk, on the CPU.

On a CUDA device the engine captures graphs of K = 1, 2, 4, 8 and 16
steps over a ``[16, N, I]`` frame buffer and a ``[16, N, O]`` output
buffer, each at its first use, and runs a chunk of T frames as
``chunk_plan(T)``: T // 16 sixteen-step replays and at most one each of
8, 4, 2 and 1 steps, ``ceil(T / 16) + 4`` replays at most. Here the
capture is the stub of ``tests/test_torch_engine_graph.py`` (it records
the engine's buffers and reruns the captured body at each replay), so the
chunk path's control flow runs on the CPU: every output, the whole state
and the carry must be bit for bit the eager engine's (the CPU's own
step), for T in {1, 5, 16, 17, 300}, over a GRU ``fused_q8`` and an
``fused`` tile, an LSTM and the two delta LM cells at small widths; a
changed capture key drops the graphs and the chunks are captured again.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.deltarglru import init_deltarglru_model
from repro_torch.core.deltarwkv import init_deltarwkv_model
from repro_torch.core.program import compile_delta_program
from repro_torch.models.gru_rnn import (GruTaskConfig, init_gru_model,
                                        init_lstm_model)
from repro_torch.serve import engine as tengine

from test_torch_engine_graph import stub_capture

torch.set_num_threads(1)

I, H, O = 24, 32, 5


def _frames(t, n, width=I, seed=1):
    rng = np.random.default_rng(seed)
    xs = np.cumsum(rng.normal(0, 0.3, (t, n, width)), 0).astype(np.float32)
    if t > 3:
        xs[3, 0, 1] = np.nan
    return xs


def _program(kind, backend):
    task = GruTaskConfig(I, H, 2, O, theta_x=0.125, theta_h=0.125)
    if kind == "gru":
        model = init_gru_model(0, task, device="cpu")
    elif kind == "lstm":
        model = init_lstm_model(0, task, device="cpu")
    elif kind == "rwkv6":
        task = GruTaskConfig(64, 64, 2, O, theta_x=0.125, theta_h=0.125)
        model = init_deltarwkv_model(0, 64, 2, O, device="cpu")
    else:
        task = GruTaskConfig(64, 64, 2, O, theta_x=0.125, theta_h=0.125)
        model = init_deltarglru_model(0, 64, 2, O, device="cpu")
    return compile_delta_program(model, backend, cell=kind,
                                 device="cpu"), task


def _pair(prog, task, n):
    eager = tengine.DeltaStreamEngine(prog, task, n_streams=n, device="cpu")
    graph = tengine.DeltaStreamEngine(prog, task, n_streams=n, device="cpu")
    graph._capture = stub_capture
    graph._capture_step()
    return eager, graph


def _same(a, b):
    for x, y in zip(tengine._leaves(a.state.stack),
                    tengine._leaves(b.state.stack)):
        assert x.numpy().tobytes() == y.numpy().tobytes()
    for k in a._carry:
        assert a._carry[k].numpy().tobytes() == b._carry[k].numpy().tobytes()


@pytest.mark.parametrize("t", [0, 1, 5, 16, 17, 31, 32, 300])
def test_chunk_plan(t):
    plan = tengine.chunk_plan(t)
    assert sum(plan) == t
    assert len(plan) <= math.ceil(t / 16) + 4
    assert plan == sorted(plan, reverse=True)
    assert set(plan) <= set(tengine.CHUNK_STEPS)
    assert len(plan) - plan.count(16) == len(set(plan) - {16})


PATHS = [("gru", "fused_q8", 1), ("gru", "fused", 3), ("lstm", "fused_q4", 2),
         ("rwkv6", "fused", 2), ("rglru", "fused", 1)]


# the LM cells (a few ms a step on the CPU) up to T = 17
CHUNK_CASES = [(t, p) for p in range(len(PATHS)) for t in (1, 5, 16, 17, 300)
               if t < 300 or PATHS[p][0] in ("gru", "lstm")]


@pytest.mark.parametrize("t,path", CHUNK_CASES)
def test_step_many_replays_chunks_bitwise_the_eager_steps(t, path):
    kind, backend, n = PATHS[path]
    prog, task = _program(kind, backend)
    eager, graph = _pair(prog, task, n)
    xs = _frames(t, n, task.input_size)
    want = eager.step_many(xs)
    before = dict(graph.graph_stats)
    got = graph.step_many(xs)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    _same(eager, graph)
    assert graph.report() == eager.report()
    replays = graph.graph_stats["replays"] - before["replays"]
    assert replays == len(tengine.chunk_plan(t)) <= math.ceil(t / 16) + 4
    assert graph.graph_stats["steps"] - before["steps"] == t
    # each chunk length captured once, at its first use
    assert sorted(graph._graphs) == sorted({1, *tengine.chunk_plan(t)})
    assert graph.graph_stats["captures"] == len(graph._graphs)
    # again: no capture, the same bits
    a, b = eager.step_many(xs), graph.step_many(xs)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    assert graph.graph_stats["captures"] == len(graph._graphs)


def test_a_changed_key_recaptures_the_chunks():
    prog, task = _program("gru", "fused_q8")
    eager, graph = _pair(prog, task, 2)
    xs = _frames(40, 2)
    for eng in (eager, graph):
        eng.step_many(xs[:23])                     # 16 + 4 + 2 + 1
    assert sorted(graph._graphs) == [1, 2, 4, 16]
    captures = graph.graph_stats["captures"]
    for eng in (eager, graph):
        eng.theta_x = 0.25
        eng.step_many(xs[23:])                     # 16 + 1, recaptured
    assert sorted(graph._graphs) == [1, 16]
    assert graph.graph_stats["captures"] == captures + 2
    _same(eager, graph)
    assert graph.report() == eager.report()


def test_step_is_one_replay_of_the_one_step_graph():
    prog, task = _program("gru", "fused_q8")
    eager, graph = _pair(prog, task, 1)
    xs = _frames(6, 1)[:, 0]
    for x in xs:
        a, b = eager.step(x), graph.step(x)
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert graph.graph_stats["replays"] == graph.graph_stats["steps"] == 6
    assert list(graph._graphs) == [1]
    _same(eager, graph)
