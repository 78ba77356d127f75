"""``LmEngine``'s prefill as a captured program, on the CPU, against the
eager port and the JAX package's jitted prefill: one graph a prompt
signature (the tokens' shape, each modality input's name, shape and dtype
and the scan routes), at most ``PREFILL_GRAPHS`` held, least recently used
evicted first, all dropped when the engine's capture key changes.

The engine's graphs run through ``prefill_stub``, a stand-in for
``ops.capture_cuda_graph``: it records the pointers of the caches and of
the capture's input buffers (the prefill's tokens and modality buffers, or
the decode step's token buffer) and every replay fails if one moved; it
also records the scan routes live at the capture and fails a replay under
other ones, as a CUDA graph would run the route it baked in. Its replay
reruns the captured body into one output that every replay overwrites, as
a graph's static output is, and its capture counts ``STUB_LAUNCHES`` of a
kernel that the engine must take back and add again at each replay. It
keeps the memory pool it is given (a new one where none is), as a CUDA
graph captured into a live graph's pool shares it.

Held: the stub engine's logits and every cache leaf bitwise the eager
port's; its logits within ``TOL_LM`` of JAX's jitted ``LmEngine.prefill``
(``test_torch_lm_serve.py``'s bound), for every arch of the registry at its
reduced fp32 config; the batcher's tokens those of the eager port exactly
and JAX's under ``test_torch_lm_serve.py``'s margin rule.
"""
import collections
import contextlib
import gc
import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.kernels import ops
from repro_torch.models.common import tree_leaves
from repro_torch.models.rglru import assoc_route
from repro_torch.models.rwkv import chunked_route
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from test_torch_lm_serve import (KINDS, _drive, _model, _modality,
                                 _recording, _same_tokens)

torch.set_num_threads(1)

TOL_LM = 2e-5
# the launches a stub capture counts (a capture calls every wrapper once)
STUB_KERNEL = ops.RWKV6_SCAN_BF16
STUB_LAUNCHES = 5
# the ids of the stub's new pools
_POOLS = itertools.count(1)


def prefill_stub(body, pool=None, stream=None):
    """``ops.capture_cuda_graph`` for ``LmEngine`` on the CPU (the module
    docstring)."""
    free = inspect.getclosurevars(body).nonlocals
    eng = free["self"]
    inputs = ([free["tok_buf"], *free["bufs"].values()] if "tok_buf" in free
              else [eng._tokens])

    def ptrs():
        return [t.data_ptr() for t in tree_leaves(eng._caches) + inputs]

    held, routes, static = ptrs(), (chunked_route(), assoc_route()), []
    STUB_KERNEL.launches += STUB_LAUNCHES

    def replay():
        assert ptrs() == held, ("a cache or an input buffer was rebound "
                                "after the capture")
        assert (chunked_route(), assoc_route()) == routes, (
            "a replay under other scan routes than its capture's")
        out = body()
        if not static:
            static.append(torch.empty_like(out))
        static[0].copy_(out)
        return static[0]

    replay.pool = (next(_POOLS), 0) if pool is None else pool
    return replay


def _engine(tp, tcfg, batch, max_len, stub):
    eng = tengine.LmEngine(tp, tcfg, batch=batch, max_len=max_len,
                           device="cpu")
    if stub:
        eng._capture = prefill_stub
    return eng


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.caches),
                                                 tree_leaves(b.caches)))


def _prompts(vocab, s, seed):
    return np.random.default_rng(seed).integers(1, vocab, (2, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", tuple(jreg.ARCH_IDS))
def test_prefill_graph_matches_eager_and_jax(arch):
    """Three prefills of two signatures through the stub engine and the
    eager engine: logits and every cache leaf bitwise equal after each;
    the first within ``TOL_LM`` of JAX's jitted prefill; two captures,
    three replays, each replay adding the launches its capture took back;
    the eager engine captures nothing."""
    jcfg, tcfg, jp, tp = _model(arch)
    mod = _modality(jcfg)
    calls = [_prompts(jcfg.vocab, 5, 3), _prompts(jcfg.vocab, 3, 4),
             _prompts(jcfg.vocab, 5, 5)]
    want = jengine.LmEngine(jp, jcfg, batch=2, max_len=32).prefill(
        jnp.asarray(calls[0]), **{k: jnp.asarray(v) for k, v in mod.items()})
    eager = _engine(tp, tcfg, 2, 32, stub=False)
    graph = _engine(tp, tcfg, 2, 32, stub=True)
    ops.reset_launch_counts()
    for i, toks in enumerate(calls):
        e = eager.prefill(toks, **mod)
        g = graph.prefill(toks, **mod)
        assert torch.equal(e, g) and _same_state(eager, graph)
        if i == 0:
            w = np.asarray(want, np.float32)
            err = (np.abs(g.float().numpy() - w).max()
                   / max(1.0, np.abs(w).max()))
            assert err <= TOL_LM
    stats = graph.prefill_stats
    assert (stats["captures"], stats["replays"], stats["held"],
            stats["evictions"]) == (2, 3, 2, 0)
    assert STUB_KERNEL.launches == 3 * STUB_LAUNCHES
    assert [v["replays"] for v in graph.prefill_graphs().values()] == [1, 2]
    assert all(v["pool_bytes"] is None
               for v in graph.prefill_graphs().values())
    assert eager.prefill_stats == {"captures": 0, "capture_s": 0.0,
                                   "replays": 0, "evictions": 0, "held": 0}


def _counting_warmups(monkeypatch) -> list:
    """Count the engine's warm-ups (its calls of ``ops.run_aside``)."""
    calls, run_aside = [], ops.run_aside

    def counted(*args):
        calls.append(1)
        return run_aside(*args)

    monkeypatch.setattr(ops, "run_aside", counted)
    return calls


def test_a_signature_past_the_bound_evicts_and_recaptures(monkeypatch):
    """``PREFILL_GRAPHS + 1`` prompt lengths (the bound set to 8 here, the
    prompts within the ring) evict the least recently used graph; its
    length captures again at its next use, evicting the next one; every
    prefill bitwise the eager engine's; the graphs held share one pool,
    and only the first capture warms up."""
    jcfg, tcfg, _, tp = _model("llama3.2-1b")
    monkeypatch.setattr(tengine, "PREFILL_GRAPHS", 8)
    warmups = _counting_warmups(monkeypatch)
    n = tengine.PREFILL_GRAPHS
    eager = _engine(tp, tcfg, 2, 32, stub=False)
    graph = _engine(tp, tcfg, 2, 32, stub=True)
    lengths = list(range(1, n + 2)) + [1, n + 1]
    for s in lengths:
        toks = _prompts(jcfg.vocab, s, s)
        assert torch.equal(eager.prefill(toks), graph.prefill(toks))
        assert _same_state(eager, graph)
    stats = graph.prefill_stats
    assert (stats["captures"], stats["replays"], stats["held"],
            stats["evictions"]) == (n + 2, n + 3, n, 2)
    held = [sig[0][1] for sig in graph.prefill_graphs()]
    assert held == list(range(3, n + 1)) + [1, n + 1]
    assert len({g["pool"] for g in graph.prefill_graphs().values()}) == 1
    assert len(warmups) == 1


def test_a_changed_key_drops_the_graphs(monkeypatch):
    """A new parameter tree (a changed ``_capture_key``) drops every
    prefill graph: the same signature captures again, into a new pool,
    after a warm-up of its own."""
    jcfg, tcfg, _, tp = _model("llama3.2-1b")
    warmups = _counting_warmups(monkeypatch)
    graph = _engine(tp, tcfg, 2, 32, stub=True)
    toks = _prompts(jcfg.vocab, 4, 1)
    graph.prefill(toks)
    graph.prefill(_prompts(jcfg.vocab, 3, 1))
    graph.prefill(toks)
    assert graph.prefill_stats["captures"] == 2
    (old_pool,) = {g["pool"] for g in graph.prefill_graphs().values()}
    assert len(warmups) == 1
    graph.params = dict(tp)
    graph.prefill(toks)
    assert graph.prefill_stats["captures"] == 3
    assert graph.prefill_stats["held"] == 1
    assert graph.prefill_stats["evictions"] == 0
    assert [g["pool"] for g in graph.prefill_graphs().values()] != [old_pool]
    assert len(warmups) == 2


@pytest.mark.parametrize("arch", ("llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"))
def test_modality_prompts_of_new_lengths_share_the_warm_up(arch,
                                                          monkeypatch):
    """The warm-up runs once a signature but for the prompt's length: the
    VLM's and the encoder-decoder's prefills at three prompt lengths warm
    up once and capture three graphs, each bitwise the eager engine's."""
    jcfg, tcfg, _, tp = _model(arch)
    warmups = _counting_warmups(monkeypatch)
    mod = _modality(jcfg)
    eager = _engine(tp, tcfg, 2, 32, stub=False)
    graph = _engine(tp, tcfg, 2, 32, stub=True)
    for s in (5, 3, 7, 3):
        toks = _prompts(jcfg.vocab, s, s)
        assert torch.equal(eager.prefill(toks, **mod),
                           graph.prefill(toks, **mod))
        assert _same_state(eager, graph)
    assert graph.prefill_stats["captures"] == 3
    assert graph.prefill_stats["replays"] == 4
    assert len(warmups) == 1


@pytest.mark.parametrize("arch,var", [("rwkv6-1.6b", "REPRO_RWKV_CHUNKED"),
                                      ("recurrentgemma-9b",
                                       "REPRO_RGLRU_ASSOC")])
def test_a_changed_scan_route_recaptures(arch, var, monkeypatch):
    """The scan route is part of the signature: a prompt captured under
    the default route captures again under ``var=1`` (the stub fails a
    replay under another route than its capture's), each bitwise the
    eager engine's under the same route; back at the default route the
    first graph replays. Each route warms up once."""
    jcfg, tcfg, _, tp = _model(arch)
    warmups = _counting_warmups(monkeypatch)
    toks = _prompts(jcfg.vocab, 6, 2)
    eager = _engine(tp, tcfg, 2, 32, stub=False)
    graph = _engine(tp, tcfg, 2, 32, stub=True)
    outs = []
    for value in ("0", "1", "0"):
        monkeypatch.setenv(var, value)
        e, g = eager.prefill(toks), graph.prefill(toks)
        assert torch.equal(e, g) and _same_state(eager, graph)
        outs.append(g)
    assert graph.prefill_stats["captures"] == 2
    assert graph.prefill_stats["replays"] == 3
    assert not torch.equal(outs[0], outs[1])
    assert len(warmups) == 2


def test_returned_prefill_logits_are_not_overwritten():
    """The graph's logits buffer is overwritten by every replay; each
    ``prefill`` hands out a copy, as JAX returns an immutable array."""
    jcfg, tcfg, _, tp = _model("llama3.2-1b")
    eng = _engine(tp, tcfg, 2, 32, stub=True)
    first = eng.prefill(_prompts(jcfg.vocab, 4, 7))
    kept = first.clone()
    second = eng.prefill(torch.from_numpy(_prompts(jcfg.vocab, 4, 8)))
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr()
    assert eng.prefill_stats["captures"] == 1


def test_prefill_refuses_another_batch():
    jcfg, tcfg, _, tp = _model("llama3.2-1b")
    eng = _engine(tp, tcfg, 2, 32, stub=True)
    with pytest.raises(ValueError, match="a prompt a slot"):
        eng.prefill(_prompts(jcfg.vocab, 4, 1)[:1])
    assert eng.prefill_stats["captures"] == 0


# staggered waves over 3 slots: a wave of three (its longest prompt 6
# tokens), then one request a wave as slots free up, of 4, 6, 4 and 7
# tokens: five waves of three lengths
WAVE_LENGTHS = (6, 2, 3, 4, 6, 4, 7)
WAVE_BUDGETS = (2, 5, 6, 3, 4, 2, 3)


@pytest.mark.parametrize("arch", KINDS)
def test_batcher_waves_capture_one_graph_a_length(arch):
    """A ``ContinuousBatcher`` over the stub engine admits staggered waves
    of three lengths into a partly occupied batch: the same events and
    tokens as over the eager engine exactly, JAX's under the margin rule;
    one capture a distinct wave length, a replay a wave."""
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, jcfg.vocab, n).tolist() for n in WAVE_LENGTHS]
    budgets = list(WAVE_BUDGETS)
    jcb = jsched.ContinuousBatcher(jengine.LmEngine(jp, jcfg, batch=3,
                                                    max_len=48))
    margins, tols = collections.defaultdict(list), []
    _recording(jcb, margins, tols)
    jev, jout = _drive(jcb, prompts, budgets)
    graph = _engine(tp, tcfg, 3, 48, stub=True)
    waves = []
    prefill = graph.prefill

    def recorded(tokens):
        waves.append(tokens.shape[1])
        return prefill(tokens)

    graph.prefill = recorded
    gev, gout = _drive(tsched.ContinuousBatcher(graph), prompts, budgets)
    eev, eout = _drive(tsched.ContinuousBatcher(
        _engine(tp, tcfg, 3, 48, stub=False)), prompts, budgets)
    assert waves == [6, 4, 6, 4, 7]
    assert graph.prefill_stats["captures"] == len(set(waves))
    assert graph.prefill_stats["replays"] == len(waves)
    assert gev == eev == jev and gout == eout
    for uid, want in jout.items():
        assert len(gout[uid]) == budgets[uid]
        _same_tokens(gout[uid], want, margins[uid], max(tols))



class _FakeGraph:
    """``torch.cuda.CUDAGraph`` without a card: records whether the cyclic
    garbage collector was on while the stream captured."""

    def __init__(self):
        self.collecting = []

    def capture_begin(self, pool=None):
        self.collecting.append(gc.isenabled())

    def capture_end(self):
        self.collecting.append(gc.isenabled())

    def pool(self):
        return (7, 0)


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("enabled", (True, False))
def test_no_garbage_collection_while_a_stream_captures(enabled, monkeypatch):
    """``ops.capture_cuda_graph`` turns the cyclic collector off from the
    capture's begin to its end (a graph freed by a collection during a
    capture would destroy its executable graph, which CUDA forbids, and
    the capture fails), then back to what it was, also when the body
    raises."""
    graphs, empty = [], torch.empty

    def fake_graph():
        graphs.append(_FakeGraph())
        return graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", fake_graph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    seen = []

    def body():
        seen.append(gc.isenabled())
        return torch.zeros(2)

    was = gc.isenabled()
    try:
        gc.enable() if enabled else gc.disable()
        replay = ops.capture_cuda_graph(body)
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError, match="body"):
            ops.capture_cuda_graph(lambda: (_ for _ in ()).throw(
                RuntimeError("body")))
        assert gc.isenabled() == enabled
    finally:
        gc.enable() if was else gc.disable()
    assert seen == [False]
    assert [g.collecting for g in graphs] == [[False, False]] * 2
    assert replay.pool == (7, 0) and set(replay.split) == {"body_s",
                                                           "end_s"}
