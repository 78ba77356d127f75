"""The rest of the port's LM training path against the JAX package, on the
CPU: gradient accumulation, a gradient transform and ``train_loop``
(through the helpers and tolerances of ``tests/test_torch_lm_train.py``),
the synthetic LM data (``data/lm_data.py``), the ``Prefetcher``
(``data/pipeline.py``), the scans' autograd guard and the blocks' choice
of scan, the training launcher (``launch/train.py``) and an LM
``TrainState`` checkpoint across the packages.

Tolerances, where they are not the first file's: the tokens are bitwise
JAX's but where a token's ``u ** (-1/1.1)`` lies within one float32 ulp of
an integer (XLA's ``pow`` against torch's), and each such token is shown
to sit on that boundary (none in these draws); ``train_loop``'s losses
within 1e-4 relative (four Adam steps); checkpoints bitwise.
"""
import json
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import lm_data as jdata
from repro.data import pipeline as jpipe
from repro.dist import grad_compress as jgc
from repro.ft import checkpoint as jckpt
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.configs import registry as treg
from repro_torch.data import lm_data as tdata
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import grad_compress as tgc
from repro_torch.dist import sharding as tsharding
from repro_torch.ft import checkpoint as tckpt
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as trglru_scan
from repro_torch.kernels import rwkv6_scan as trwkv6_scan
from repro_torch.launch import train as tlaunch
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer
from test_torch_lm_train import (MOE, ROUTE_GAP, TOL_GRAD, S, _jb, _jgrads,
                                 _metrics_close, _min_route_gap, _model,
                                 _opt, _params_within, _record_routes, _tb,
                                 _tol_grad)

torch.set_num_threads(1)

ARCHS = tuple(jreg.ARCH_IDS)


# -- gradient accumulation, a gradient transform, the loop ----------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b",
                                  "recurrentgemma-9b",
                                  "granite-moe-3b-a800m"])
def test_grad_accum_matches_jax(arch, monkeypatch):
    """``grad_accum=2`` (two microbatches of 2): the averaged metrics
    against JAX's ``lax.scan`` within ``TOL_METRIC`` (counts equal), the
    parameters within Adam's bound of the fp32-averaged gradient."""
    jcfg, tcfg, jp, tp, batch = _model(arch)
    calls = _record_routes(monkeypatch) if arch in MOE else None
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    jgs = [_jgrads(jcfg, jp, h)[1] for h in halves]
    jg = [(np.float32(0) + a + b) / np.float32(2) for a, b in zip(*jgs)]
    jstep = jax.jit(jtrainer.make_lm_train_step_fn(jcfg, _opt(joptim),
                                                   grad_accum=2))
    tstep = ttrainer.make_lm_train_step_fn(tcfg, _opt(toptim), grad_accum=2)
    js, jm = jstep(jtrainer.init_train_state(jp), _jb(batch))
    ts, tm = tstep(ttrainer.init_train_state(tp), _tb(batch))
    _metrics_close(tm, jm, _tol_grad(arch))
    _params_within(ts, js, jg, float(jm["grad_norm"]), _tol_grad(arch))
    if calls is not None:
        assert len(calls) == 2 * tcfg.n_layers
        assert _min_route_gap(calls) >= ROUTE_GAP


def test_grad_accum_needs_a_dividing_batch_and_no_mesh_rules():
    """A batch that does not split raises, as does ``grad_accum=0``;
    ``accum_rules`` without a mesh is ignored, as in the reference: the
    step equals the step without it, bitwise."""
    _, tcfg, _, tp, batch = _model("llama3.2-1b")
    step = ttrainer.make_lm_train_step_fn(tcfg, _opt(toptim), grad_accum=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(ttrainer.init_train_state(tp), _tb(batch))
    plain, ruled = (ttrainer.make_lm_train_step_fn(
        tcfg, _opt(toptim), grad_accum=2, accum_rules=rules)(
            ttrainer.init_train_state(tp), _tb(batch))
        for rules in (None, tsharding.AxisRules()))
    for a, b in zip(toptim.tree_leaves(plain[0]), toptim.tree_leaves(
            ruled[0])):
        assert torch.equal(a, b)
    assert all(torch.equal(plain[1][k], ruled[1][k]) for k in plain[1])
    with pytest.raises(ValueError, match="grad_accum"):
        ttrainer.make_lm_train_step_fn(tcfg, _opt(toptim), grad_accum=0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_grad_transform_compress_matches_jax(arch):
    """``grad_transform``: each package's ``compress`` (a fresh residual,
    θ at the median |gradient|, so half the elements are sent). The
    metrics within ``TOL_METRIC``; the parameters within Adam's bound
    through the threshold (an element within ``TOL_GRAD`` of θ may be sent
    in one package and not the other: the bound covers it)."""
    jcfg, tcfg, jp, tp, batch = _model(arch)
    _, jg = _jgrads(jcfg, jp, batch)
    theta = float(np.median(np.abs(np.concatenate([g.ravel() for g in jg]))))
    jcc = jgc.CompressionConfig(theta=theta)
    tcc = tgc.CompressionConfig(theta=theta)
    jstep = jtrainer.make_lm_train_step(
        jcfg, _opt(joptim), donate=False,
        grad_transform=lambda g: jgc.compress(g, jgc.init_residual(g),
                                              jcc)[0])
    tstep = ttrainer.make_lm_train_step(
        tcfg, _opt(toptim),
        grad_transform=lambda g: tgc.compress(g, tgc.init_residual(g),
                                              tcc)[0])
    js, jm = jstep(jtrainer.init_train_state(jp), _jb(batch))
    ts, tm = tstep(ttrainer.init_train_state(tp), _tb(batch))
    _metrics_close(tm, jm, TOL_GRAD)
    _params_within(ts, js, jg, float(jm["grad_norm"]), TOL_GRAD,
                   theta=np.float32(theta))
    # the transform ran: about half the parameters did not move
    moved = sum(int((a != b).sum()) for a, b in zip(
        toptim.tree_leaves(ts.params), toptim.tree_leaves(tp)))
    total = sum(p.numel() for p in toptim.tree_leaves(tp))
    assert 0.3 < moved / total < 0.7



@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_train_loop_histories_match_jax(arch):
    """``train_loop`` over 4 batches, each package's step from the same
    state: the same keys, the hook calls, and each step's loss within
    1e-4 relative (four Adam steps, each a near-sign update of gradients
    that agree to ~1e-6; measured at most 1.9e-7 here)."""
    jcfg, tcfg, jp, tp, _ = _model(arch)
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, jcfg.vocab, (2, S)).astype(
        np.int32)} for _ in range(4)]
    jstep = jtrainer.make_lm_train_step(jcfg, _opt(joptim), donate=False)
    tstep = ttrainer.make_lm_train_step(tcfg, _opt(toptim))
    seen = []
    _, jh = jtrainer.train_loop(jstep, jtrainer.init_train_state(jp),
                                [_jb(b) for b in batches], 4)
    ts, th = ttrainer.train_loop(
        tstep, ttrainer.init_train_state(tp), [_tb(b) for b in batches], 4,
        ttrainer.LoopHooks(on_step=lambda i, m: seen.append(i),
                           checkpoint_every=2,
                           save_checkpoint=lambda i, s: seen.append(
                               ("ckpt", i, int(s.step)))))
    assert seen == [0, 1, ("ckpt", 2, 2), 2, 3, ("ckpt", 4, 4)]
    assert [sorted(h) for h in th] == [sorted(h) for h in jh]
    for a, b in zip(jh, th):
        assert all(isinstance(v, float) for v in b.values())
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
    assert int(ts.step) == 4


# -- the data -----------------------------------------------------------------

def _jax_draws(key, b, s, vocab):
    """The draws of ``repro.data.lm_data.token_batch``, repeated."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {"u": jax.random.uniform(k1, (b, s), minval=1e-6),
            "rep": jax.random.randint(k2, (b, s), 0, vocab // 64 + 2),
            "use_rep": jax.random.bernoulli(k3, 0.3, (b, s))}


@pytest.mark.parametrize("vocab", [128, 49155, 128256, 256000])
def test_token_build_of_jax_draws_matches_token_batch(vocab):
    """``token_build`` fed JAX's own draws equals ``token_batch(key)`` token
    for token, but where the Zipf rank's ``u ** (-1/1.1)`` lies within one
    ulp of an integer in either library: such a token differs by one and
    its two fp32 powers straddle the integer (counted: none over these
    4 × 1024 tokens a vocabulary, nor over 20 seeds of 2048 when
    measured)."""
    on_boundary = 0
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, 8, 128, vocab)
        want = np.asarray(jdata.token_batch(key, 8, 128, vocab))
        got = tdata.token_build(
            **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
            vocab=vocab, device="cpu")
        assert got.dtype == torch.int32 and got.shape == (8, 128)
        got = got.numpy()
        diff = got != want
        if diff.any():
            u = np.asarray(draws["u"])[diff]
            t_pow = (torch.from_numpy(u) ** (-1.0 / 1.1)).numpy()
            j_pow = np.asarray(jnp.asarray(u) ** (-1.0 / 1.1))
            assert (np.abs(got[diff].astype(np.int64) - want[diff]) == 1).all()
            assert (np.abs(t_pow - j_pow)
                    <= np.spacing(np.maximum(t_pow, j_pow))).all()
            assert (np.floor(t_pow) != np.floor(j_pow)).all()
            on_boundary += int(diff.sum())
    assert on_boundary <= 4 * 1024 * 1e-3


def test_token_draws_follow_jax_distribution():
    """The port's own draws: ``u`` in [1e-6, 1), ``rep`` in its range,
    ``use_rep`` at 0.3; the same seed gives the same tokens; the shares of
    the three most frequent tokens within 0.02 of JAX's over 16384
    tokens (each share's sampling error is ~0.004)."""
    d = tdata.token_draws(0, 64, 256, 50000)
    assert d["u"].dtype == torch.float32
    assert float(d["u"].min()) >= 1e-6 and float(d["u"].max()) < 1.0
    assert d["rep"].dtype == torch.int32
    assert 0 <= int(d["rep"].min()) and int(d["rep"].max()) < 50000 // 64 + 2
    assert d["use_rep"].dtype == torch.bool
    assert abs(float(d["use_rep"].float().mean()) - 0.3) < 0.01
    a = tdata.token_batch(3, 64, 256, 50000, device="cpu")
    assert torch.equal(a, tdata.token_batch(3, 64, 256, 50000, device="cpu"))
    j = np.asarray(jdata.token_batch(jax.random.PRNGKey(3), 64, 256, 50000))
    for tok in (0, 1, 2):
        assert abs(float((a == tok).float().mean())
                   - float((j == tok).mean())) < 0.02


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_batch_keys_shapes_dtypes_match_jax(arch):
    """At the reduced and the full config: the keys, shapes and dtypes of
    JAX's ``lm_batch`` (tokens int32, the modality stub fp32); the image
    embeddings scaled by 0.02, the audio frames standard normal."""
    for reduced in (True, False):
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        if reduced:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        want = jax.eval_shape(
            lambda: jdata.lm_batch(jax.random.PRNGKey(0), jcfg, 2, 8))
        got = tdata.lm_batch(0, tcfg, 2, 8, device="cpu")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
        assert int(got["tokens"].min()) >= 0
        assert int(got["tokens"].max()) < tcfg.vocab
        if "image_embeds" in got:
            assert abs(float(got["image_embeds"].std()) - 0.02) < 0.004
        if "audio_frames" in got:
            assert abs(float(got["audio_frames"].std()) - 1.0) < 0.2


def test_lm_batch_stream_continues_from_its_start():
    """Step ``i`` of a stream seeded ``(1, s)`` is the batch seeded ``(1,
    s + i)``: the stream seeded ``(1, 3)`` starts where the one seeded
    ``(1, 0)`` is at step 3. An int seed ``s`` is ``(s,)``; a generator
    and the int it was seeded with give the same batch."""
    cfg = treg.get_config("llama3.2-1b").reduced()
    whole = tdata.lm_batch_stream((1, 0), cfg, 2, 8, device="cpu")
    first = [next(whole)["tokens"] for _ in range(5)]
    later = tdata.lm_batch_stream((1, 3), cfg, 2, 8, device="cpu")
    assert torch.equal(next(later)["tokens"], first[3])
    assert torch.equal(next(later)["tokens"], first[4])
    assert not torch.equal(first[0], first[1])
    ints = tdata.lm_batch_stream(5, cfg, 2, 8, device="cpu")
    assert torch.equal(next(ints)["tokens"],
                       tdata.lm_batch((5,), cfg, 2, 8, device="cpu")["tokens"])
    g = torch.Generator().manual_seed(4)
    assert torch.equal(tdata.lm_batch(g, cfg, 2, 8, device="cpu")["tokens"],
                       tdata.lm_batch(4, cfg, 2, 8, device="cpu")["tokens"])


# -- the prefetcher ---------------------------------------------------------------

PREFETCHERS = {"jax": jpipe.Prefetcher, "torch": tpipe.Prefetcher}


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetcher_order_matches_jax(depth):
    items = [{"i": i} for i in range(12)]
    for cls in PREFETCHERS.values():
        assert list(cls(iter(items), depth=depth)) == items


def test_prefetcher_raises_the_worker_error_on_the_consumer_side():
    def gen():
        yield 0
        yield 1
        raise ValueError("bad batch 2")
    for cls in PREFETCHERS.values():
        pf = cls(gen(), depth=4)
        assert [next(pf), next(pf)] == [0, 1]
        with pytest.raises(ValueError, match="bad batch 2"):
            next(pf)


def test_prefetcher_close_matches_jax():
    """Closed with one item read, ``depth`` queued and one more pulled and
    waiting: both packages hand out the queued and the waiting items, pull
    one more, and end; the worker thread exits."""
    seen = {}
    for name, cls in PREFETCHERS.items():
        pulled = []

        def gen(pulled=pulled):
            for i in range(100):
                pulled.append(i)
                yield i
        pf = cls(gen(), depth=2)
        assert next(pf) == 0
        deadline = time.monotonic() + 30
        while len(pulled) < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.1)           # the worker waits on the full queue
        pf.close()
        rest = list(pf)
        pf._thread.join(timeout=30)
        assert not pf._thread.is_alive()
        seen[name] = (rest, list(pulled))
    assert seen["torch"] == seen["jax"] == ([1, 2, 3], [0, 1, 2, 3, 4])


# -- the scans under autograd -------------------------------------------------------

def _scan_args(scan, grad):
    g = torch.Generator().manual_seed(0)
    if scan == "rwkv6":
        r, k, v = (torch.randn(1, 2, 3, 64, generator=g) for _ in range(3))
        w = torch.rand(1, 2, 3, 64, generator=g)
        args = [r, k, v, w, torch.randn(2, 64, generator=g)]
    else:
        args = [torch.randn(1, 3, 8, generator=g),
                torch.rand(1, 3, 8, generator=g)]
    args[-1].requires_grad_(grad)
    return args


@pytest.mark.parametrize("scan", ["rwkv6", "rglru"])
def test_scan_kernel_refuses_operands_autograd_records(scan, monkeypatch):
    """With the dispatch made to take the kernel (``launches_kernel``
    patched to True where the wrapper reads it), a call on an operand that
    requires grad, with grad mode on, raises before the launch and counts
    nothing; without autograd (no grad mode, or no operand requiring grad)
    the call goes on to the launch, whose operand check then refuses the
    CPU tensors."""
    mod = trwkv6_scan if scan == "rwkv6" else trglru_scan
    fn = getattr(ops, f"{scan}_scan")
    monkeypatch.setattr(mod, "launches_kernel", lambda *t: True)
    monkeypatch.setattr(ops, "launches_kernel", lambda *t: True)
    ops.reset_launch_counts()
    args = _scan_args(scan, grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        fn(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*_scan_args(scan, grad=False))
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_blocks_choose_the_scan_by_autograd(arch, monkeypatch):
    """A train step calls the plain scan by name and never ``ops``' (the
    kernel's entry); serving calls ``ops``' once a recurrent layer, with
    grad mode off and with it on over parameters that do not require grad;
    a forward over parameters that require grad calls the plain one."""
    name = "rwkv6_scan" if arch.startswith("rwkv6") else "rglru_scan"
    kind = "rwkv" if arch.startswith("rwkv6") else "rglru"
    calls, orig = [], getattr(ops, name)
    monkeypatch.setattr(ops, name, lambda *a: calls.append(1) or orig(*a))
    _, tcfg, _, tp, batch = _model(arch)
    tokens = _tb(batch)["tokens"]
    layers = sum(count * pattern.count(kind)
                 for pattern, count in tblocks.make_schedule(tcfg))
    step = ttrainer.make_lm_train_step(tcfg, _opt(toptim))
    step(ttrainer.init_train_state(tp), _tb(batch))
    assert calls == [] and layers > 0
    with torch.no_grad():
        tlm.lm_prefill(tp, tcfg, tokens,
                       tlm.init_lm_caches(tcfg, 4, 32, device="cpu"))
    assert len(calls) == layers
    assert torch.is_grad_enabled()
    tlm.lm_prefill(tp, tcfg, tokens,
                   tlm.init_lm_caches(tcfg, 4, 32, device="cpu"))
    assert len(calls) == 2 * layers
    live = toptim.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    tlm.lm_forward(live, tcfg, tokens)
    assert len(calls) == 2 * layers


# -- the launcher ------------------------------------------------------------------

LINE = re.compile(r"^step +(\d+) loss +(\d+\.\d{4}) +\d+\.\d ms/step "
                  r"acc \d\.\d{3}$")


def test_launch_train_cli_prints_and_resumes(tmp_path, capsys):
    """``main`` with the reference's flags and ``--device cpu``: the mesh
    line, a loss line a step, the final line; a second call resumes from
    the checkpoint the first left, and its steps repeat an uninterrupted
    run's losses exactly (the batch of step i is seeded ``(1, i)`` either
    way)."""
    base = ["--arch", "smollm-360m", "--reduced", "--batch", "4", "--seq",
            "32", "--device", "cpu", "--log-every", "1"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"]
    first = tlaunch.main(base + ["--steps", "3"] + ck)
    out1 = capsys.readouterr().out.splitlines()
    second = tlaunch.main(base + ["--steps", "5"] + ck)
    out2 = capsys.readouterr().out.splitlines()
    whole = tlaunch.main(base + ["--steps", "5"])
    out3 = capsys.readouterr().out.splitlines()
    assert out1[0] == ("[train] smollm-360m-smoke on mesh "
                       "{'data': 1, 'model': 1}")
    assert [int(LINE.match(line).group(1)) for line in out1[1:4]] == [1, 2, 3]
    assert out1[4].startswith("[train] done: final loss ")
    assert out2[1] == "[train] resumed from step 3"
    assert [int(LINE.match(line).group(1)) for line in out2[2:4]] == [4, 5]
    assert first["start"] == 0 and second["start"] == 3
    assert first["losses"] == whole["losses"][:3]
    assert second["losses"] == whole["losses"][3:]
    assert [LINE.match(line).group(2) for line in out2[2:4]] == [
        LINE.match(line).group(2) for line in out3[4:6]]
    assert all(np.isfinite(whole["losses"])) and len(whole["step_ms"]) == 5


def test_launch_train_grad_accum_and_mesh_flags(capsys):
    """``--grad-accum 2`` trains; ``--model-parallel 2`` clamps to the one
    device, a (1, 1) mesh, and repeats ``--model-parallel 1``'s losses
    bitwise."""
    base = ["--arch", "llama3.2-1b", "--reduced", "--batch", "4", "--seq",
            "16", "--device", "cpu", "--steps", "2"]
    out = tlaunch.main(base + ["--grad-accum", "2"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    capsys.readouterr()
    one = tlaunch.main(base + ["--model-parallel", "1"])
    two = tlaunch.main(base + ["--model-parallel", "2"])
    assert two["losses"] == one["losses"] and len(one["losses"]) == 2
    lines = capsys.readouterr().out.splitlines()
    assert lines.count("[train] llama3.2-1b-smoke on mesh "
                       "{'data': 1, 'model': 1}") == 2


# -- checkpoints across the packages ----------------------------------------------

def _manifest_entries(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return [(e["path"], e["shape"], e["dtype"])
                for e in json.load(f)["leaves"]]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_lm_train_state_checkpoint_across_packages(arch, writer, tmp_path):
    """A ``TrainState`` after one step: both packages' manifests name the
    same leaves, leaf path for leaf path, and each package restores the
    other's checkpoint bitwise."""
    jcfg, tcfg, jp, tp, batch = _model(arch)
    jstep = jtrainer.make_lm_train_step(jcfg, _opt(joptim), donate=False)
    tstep = ttrainer.make_lm_train_step(tcfg, _opt(toptim))
    js, _ = jstep(jtrainer.init_train_state(jp), _jb(batch))
    ts, _ = tstep(ttrainer.init_train_state(tp), _tb(batch))
    jckpt.save(str(tmp_path / "j"), 1, js)
    tckpt.save(str(tmp_path / "t"), 1, ts)
    jm = _manifest_entries(str(tmp_path / "j" / "step_00000001"))
    assert jm == _manifest_entries(str(tmp_path / "t" / "step_00000001"))
    assert (".opt/step", [], "int32") in jm
    if writer == "jax":
        got = tckpt.restore(str(tmp_path / "j"), ts, device="cpu")
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
        for a, b in zip(want, toptim.tree_leaves(got)):
            np.testing.assert_array_equal(a, b.numpy())
        assert got.step.dtype == torch.int32 and int(got.step) == 1
    else:
        got = jckpt.restore(str(tmp_path / "t"), js)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        toptim.tree_leaves(ts)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert got.opt["step"].dtype == jnp.int32


def test_clip_promotes_bf16_gradients_as_jax():
    """A bf16 gradient times the fp32 clip scale is fp32 in JAX (the bf16
    models' step): the port's ``clip_by_global_norm`` gives the same dtype
    and values within 1e-5 (the norm sums 2080 squares in other orders:
    1.0e-6 apart here, and the scale with it)."""
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(0, 3, (64, 32)), "b": rng.normal(0, 1, (32,))}
    jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
    tg = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
          for k, v in g.items()}
    jc, jn = joptim.clip_by_global_norm(jg, 1.0)
    tc, tn = toptim.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    for k in g:
        assert str(jc[k].dtype) == "float32" and tc[k].dtype == torch.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5)


def test_a_leaf_without_a_gradient_raises():
    """Both steps refuse a parameter leaf that autograd gave no gradient
    (here one the forward never reads), where a zero in its place would
    hide the cut."""
    _, tcfg, _, tp, batch = _model("llama3.2-1b")
    tp["unused"] = torch.zeros(3)
    step = ttrainer.make_lm_train_step(tcfg, _opt(toptim))
    with pytest.raises(RuntimeError, match="1 parameter leaves got no"):
        step(ttrainer.init_train_state(tp), _tb(batch))
    from repro_torch.models.gru_rnn import GruTaskConfig, init_gru_model
    task = GruTaskConfig(8, 16, 1, 4, task="regression")
    model = init_gru_model(0, task, device="cpu")
    model["unused"] = torch.zeros(2)
    gstep = ttrainer.make_gru_train_step(task, _opt(toptim), use_delta=False)
    feats = torch.zeros(5, 2, 8)
    with pytest.raises(RuntimeError, match="1 parameter leaves got no"):
        gstep(ttrainer.init_train_state(model),
              {"features": feats, "targets": torch.zeros(5, 2, 4)})
