"""The LM serving path of the PyTorch port (``LmEngine``,
``ContinuousBatcher``, ``_merge_caches_slotwise``, the launcher) against
the JAX package, on the CPU, at the reduced configs in fp32: every arch of
the registry through the engine (the VLM and the encoder-decoder with
seeded image embeddings / audio frames), the batcher over each cache kind.

Greedy tokens across packages: the fp32 logits agree within ``TOL_LM`` of
their magnitude (``tests/test_torch_lm.py``), so an argmax can flip only
where JAX's top two logits lie within twice that of each other. Tokens are
compared exactly up to the first such near-tie of a sequence (after it the
two runs may go different ways and are not compared), and logits
everywhere the two runs were fed the same tokens.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.common import tree_leaves
from repro_torch.serve.engine import LmEngine
from repro_torch.serve.scheduler import (ContinuousBatcher,
                                         _merge_caches_slotwise)

torch.set_num_threads(1)

TOL_LM = 2e-5
PORTED = tuple(jreg.ARCH_IDS)
# one arch of each cache kind the batcher serves: KV ring, RWKV6 state,
# RG-LRU + local ring, MLA latents (with MoE). The VLM and the
# encoder-decoder need a modality at prefill, which the batcher (as JAX's)
# does not pass.
KINDS = ("llama3.2-1b", "rwkv6-1.6b", "recurrentgemma-9b",
         "deepseek-v2-lite-16b")

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = jreg.get_config(arch).reduced()
        tcfg = treg.get_config(arch).reduced()
        jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
        tp = tlm.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


def _np(a):
    return np.asarray(a, np.float32)


def _margin(logits) -> np.ndarray:
    """Top-1 minus top-2 of each row of ``logits[:, -1]``."""
    top = np.sort(_np(logits)[:, -1], axis=-1)
    return top[:, -1] - top[:, -2]


def _flip_tol(logits) -> float:
    return 2 * TOL_LM * max(1.0, float(np.abs(_np(logits)).max()))


def _same_tokens(got: list, want: list, margins: list, tol: float) -> None:
    """``got == want`` up to the first near-tie of ``want``'s run (where
    ``margins`` is within ``tol``); a difference before it fails."""
    assert len(got) == len(want)
    for p, (g, w) in enumerate(zip(got, want)):
        if g != w:
            assert margins[p] <= tol, (
                f"token {p}: {g} != {w} with JAX's margin {margins[p]:.3e}")
            return
        if margins[p] <= tol:
            return


def _modality(cfg) -> dict:
    """Seeded image embeddings / audio frames (numpy) for the archs that
    take them, as ``lm_batch`` scales them."""
    rng = np.random.default_rng(12)
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = (rng.normal(0, 1, (
            2, cfg.n_image_tokens, cfg.vision_dim)) * 0.02).astype(np.float32)
    if cfg.encdec:
        out["audio_frames"] = rng.normal(0, 1, (
            2, cfg.n_audio_frames, cfg.audio_dim)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_lm_engine_greedy_matches_jax(arch):
    """``prefill(tokens, **modality)``, ``decode_step`` and
    ``generate_greedy(tokens, steps, **modality)`` against JAX's engine."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.random.default_rng(3).integers(1, jcfg.vocab, (2, 6)).astype(
        np.int32)
    steps = 6
    mod = _modality(jcfg)
    jmod = {k: jnp.asarray(v) for k, v in mod.items()}
    # JAX's greedy run, keeping each step's logits
    jeng = jengine.LmEngine(jp, jcfg, batch=2, max_len=48)
    lg = jeng.prefill(jnp.asarray(toks), **jmod)
    jlog, jtok = [lg], []
    cur = jnp.argmax(lg[:, -1:], axis=-1)
    for _ in range(steps):
        jtok.append(np.asarray(cur))
        lg = jeng.decode_step(cur)
        jlog.append(lg)
        cur = jnp.argmax(lg[:, -1:], axis=-1)
    want = np.concatenate(jtok, axis=1)
    np.testing.assert_array_equal(
        want, np.asarray(jengine.LmEngine(jp, jcfg, 2, 48).generate_greedy(
            jnp.asarray(toks), steps, **jmod)))
    # the port fed JAX's tokens: logits everywhere
    teng = LmEngine(tp, tcfg, batch=2, max_len=48, device="cpu")
    got_log = [teng.prefill(toks, **mod)] + [
        teng.decode_step(want[:, i:i + 1]) for i in range(steps)]
    for g, w in zip(got_log, jlog):
        err = np.abs(_np(g) - _np(w)).max() / max(1.0, np.abs(_np(w)).max())
        assert err <= TOL_LM
    # the port's own greedy run: tokens under the margin rule
    got = LmEngine(tp, tcfg, batch=2, max_len=48,
                   device="cpu").generate_greedy(toks, steps, **mod)
    assert got.shape == (2, steps)
    tol = max(_flip_tol(w) for w in jlog)
    margins = np.stack([_margin(w) for w in jlog[:steps]], axis=1)
    for row in range(2):
        _same_tokens(got[row].tolist(), want[row].tolist(), margins[row],
                     tol)


class TestServing:
    """``tests/test_train_serve.py::TestServing``'s LM tests on the port."""

    def test_lm_engine_greedy_deterministic(self):
        _, tcfg, _, _ = _model("olmo-1b")
        toks = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
        outs = [LmEngine(tlm.init_lm(0, tcfg, device="cpu"), tcfg, batch=2,
                         max_len=48, device="cpu").generate_greedy(toks, 4)
                for _ in range(2)]
        assert torch.equal(outs[0], outs[1])

    def test_continuous_batcher_drains(self):
        _, tcfg, _, tp = _model("llama3.2-1b")
        cb = ContinuousBatcher(LmEngine(tp, tcfg, batch=3, max_len=64,
                                        device="cpu"))
        uids = [cb.submit([1, 2, 3], max_new_tokens=4) for _ in range(7)]
        done = cb.run_until_drained()
        assert sorted(r.uid for r in done) == sorted(uids)
        assert all(len(r.output) == 4 and r.done for r in done)

    @pytest.mark.parametrize("arch", KINDS)
    def test_staggered_admission_keeps_live_slots(self, arch):
        """Admitting into a partly occupied batch must not clobber the
        in-flight slot: prefill writes every slot's cache in place, so the
        rows kept must be a copy taken before the wave."""
        _, tcfg, _, tp = _model(arch)
        solo = _staggered(ContinuousBatcher, lambda: LmEngine(
            tp, tcfg, batch=2, max_len=64, device="cpu"), False)
        mixed = _staggered(ContinuousBatcher, lambda: LmEngine(
            tp, tcfg, batch=2, max_len=64, device="cpu"), True)
        assert mixed[0] == solo[0]
        assert len(mixed[1]) == 4

    def test_lm_batcher_truncation_raises_too(self):
        _, tcfg, _, tp = _model("llama3.2-1b")
        cb = ContinuousBatcher(LmEngine(tp, tcfg, batch=2, max_len=64,
                                        device="cpu"))
        for _ in range(3):
            cb.submit([1, 2, 3], max_new_tokens=8)
        with pytest.raises(RuntimeError, match="truncated"):
            cb.run_until_drained(max_ticks=4)
        partial = cb.run_until_drained(max_ticks=2, strict=False)
        assert all(r.done for r in partial)


def _staggered(batcher_cls, make_engine, staggered: bool) -> dict:
    """The staggered-admission scenario of ``tests/test_train_serve.py``:
    request A, then B admitted once A has 3 tokens."""
    cb = batcher_cls(make_engine())
    cb.submit([1, 2, 3, 4], max_new_tokens=8)
    done, submitted_b = [], not staggered
    for _ in range(30):
        done += cb.step()
        if (staggered and not submitted_b and cb.slots[0] is not None
                and len(cb.slots[0].output) >= 3):
            cb.submit([5, 6, 7], max_new_tokens=4)
            submitted_b = True
        if (not staggered and len(done) == 1) or len(done) == 2:
            break
    return {r.uid: r.output for r in done}


def _recording(cb, margins: dict, tols: list) -> None:
    """Wrap ``cb.engine``'s prefill and decode_step to record, per request,
    JAX's (or the port's) margin of each token the batcher takes: at a
    prefill the wave's slots (whose requests have no output yet), at a
    decode every live slot."""
    eng = cb.engine
    prefill, decode = eng.prefill, eng.decode_step

    def record(logits, at_prefill):
        m = _margin(logits)
        tols.append(_flip_tol(logits))
        for i, req in enumerate(cb.slots):
            if req is not None and not (at_prefill and req.output):
                margins[req.uid].append(float(m[i]))
        return logits

    eng.prefill = lambda t: record(prefill(t), True)
    eng.decode_step = lambda t: record(decode(t), False)


def _drive(cb, prompts, budgets):
    """Submit, then tick to the end. Returns the events (per tick the uids
    that finished, in order) and ``{uid: output}``."""
    for p, n in zip(prompts, budgets):
        cb.submit(p, max_new_tokens=n)
    events, outputs = [], {}
    while cb.queue or any(cb.slots):
        done = cb.step()
        events.append([r.uid for r in done])
        outputs.update((r.uid, r.output) for r in done)
    return events, outputs


@pytest.mark.parametrize("arch", KINDS)
def test_batcher_matches_jax(arch):
    """The same submissions through both packages' batchers: the same
    events (which requests finish on which tick, in order), every output
    token equal under the margin rule."""
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, jcfg.vocab, int(n)).tolist()
               for n in rng.integers(2, 8, 7)]
    budgets = [int(n) for n in rng.integers(2, 6, 7)]
    jcb = jsched.ContinuousBatcher(jengine.LmEngine(jp, jcfg, batch=3,
                                                    max_len=64))
    tcb = ContinuousBatcher(LmEngine(tp, tcfg, batch=3, max_len=64,
                                     device="cpu"))
    margins, tols = collections.defaultdict(list), []
    _recording(jcb, margins, tols)
    jev, jout = _drive(jcb, prompts, budgets)
    tev, tout = _drive(tcb, prompts, budgets)
    assert tev == jev
    assert sorted(tout) == sorted(jout) == list(range(7))
    for uid, want in jout.items():
        assert len(tout[uid]) == budgets[uid]
        _same_tokens(tout[uid], want, margins[uid], max(tols))


@pytest.mark.parametrize("arch", KINDS)
def test_staggered_admission_matches_jax(arch):
    """The staggered scenario in both packages: the same tokens under the
    margin rule (the JAX run records its margins)."""
    jcfg, tcfg, jp, tp = _model(arch)
    margins, tols = collections.defaultdict(list), []

    class Recorded(jsched.ContinuousBatcher):
        def __init__(self, engine):
            super().__init__(engine)
            _recording(self, margins, tols)

    want = _staggered(Recorded, lambda: jengine.LmEngine(
        jp, jcfg, batch=2, max_len=64), True)
    got = _staggered(ContinuousBatcher, lambda: LmEngine(
        tp, tcfg, batch=2, max_len=64, device="cpu"), True)
    assert sorted(got) == sorted(want) == [0, 1]
    for uid in want:
        _same_tokens(got[uid], want[uid], margins[uid], max(tols))


def test_merge_caches_slotwise_matches_jax():
    jcfg, tcfg, _, _ = _model("recurrentgemma-9b")
    rng = np.random.default_rng(4)

    def filled(seed):
        caches = jlm.init_lm_caches(jcfg, 3, 8)
        r = np.random.default_rng(seed)
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(r.normal(0, 1, x.shape)).astype(x.dtype)
            if jnp.issubdtype(x.dtype, jnp.floating)
            else jnp.asarray(r.integers(-1, 9, x.shape)).astype(x.dtype),
            caches)

    old, new = filled(1), filled(2)
    keep = rng.uniform(size=3) < 0.5
    want = jsched._merge_caches_slotwise(old, new, jnp.asarray(keep))
    got = _merge_caches_slotwise(
        *(tlm.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, c),
                                   device="cpu") for c in (old, new)),
        torch.from_numpy(keep))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_np(g.float()), _np(w))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_merge_caches_slotwise_carries_mla_and_cross_caches(arch):
    """The slotwise merge over ``MlaCache`` and the cross caches
    (``{"ck", "cv", "self"}``), leaf for leaf against JAX's."""
    jcfg = jreg.get_config(arch).reduced()

    def filled(seed):
        r = np.random.default_rng(seed)
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(r.normal(0, 1, x.shape)).astype(x.dtype)
            if jnp.issubdtype(x.dtype, jnp.floating)
            else jnp.asarray(r.integers(-1, 9, x.shape)).astype(x.dtype),
            jlm.init_lm_caches(jcfg, 3, 8))

    old, new = filled(1), filled(2)
    keep = np.array([True, False, True])
    want = jsched._merge_caches_slotwise(old, new, jnp.asarray(keep))
    t_old, t_new = (tlm.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, c), device="cpu")
        for c in (old, new))
    got = _merge_caches_slotwise(t_old, t_new, torch.from_numpy(keep))
    kinds = {type(c).__name__ for e in got for c in e.values()}
    assert kinds == ({"MlaCache"} if jcfg.use_mla else {"dict"} | (
        {"KVCache"} if jcfg.cross_attn_every else set()))
    leaves = tree_leaves(got)
    assert len(leaves) == len(jax.tree_util.tree_leaves(want))
    for g, w in zip(leaves, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_np(g.float()), _np(w))


def test_lm_engine_refuses_params_on_another_device():
    _, tcfg, _, tp = _model("llama3.2-1b")
    eng = LmEngine(tp, tcfg, batch=2, max_len=16, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError, match="parameters lie on"):
        LmEngine({"embedding": torch.zeros(2, 2, device="meta")}, tcfg, 2,
                 16, device="cpu")


def test_launcher_runs_on_the_cpu_like_jax(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch llama3.2-1b --reduced
    --device cpu``: the requests, tokens and ticks of JAX's launcher."""
    args = ["--arch", "llama3.2-1b", "--reduced", "--requests", "5",
            "--max-new-tokens", "3", "--slots", "2"]
    tlaunch.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    from repro.launch import serve as jlaunch
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    jlaunch.main()
    want = capsys.readouterr().out.splitlines()

    def counts(line):
        words = line.replace("(", " ").replace(",", " ").split()
        return words[1], words[3], words[-2]   # requests, tokens, ticks
    assert counts(got[-1]) == counts(want[-1]) == ("5", "15", "6")
    assert got[0].startswith(want[0])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "granite-moe-3b-a800m"])
def test_launcher_serves_mla_and_moe_like_jax(arch, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --device cpu --reduced``: JAX's requests, tokens and ticks."""
    args = ["--arch", arch, "--reduced", "--requests", "5",
            "--max-new-tokens", "3", "--slots", "2"]
    tlaunch.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    from repro.launch import serve as jlaunch
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    jlaunch.main()
    want = capsys.readouterr().out.splitlines()
    assert got[-1].split()[1:6] == want[-1].split()[1:6]
    assert got[-1].split()[-2] == want[-1].split()[-2]


@pytest.mark.parametrize("arch,name", [("llama-3.2-vision-11b",
                                        "image_embeds"),
                                       ("seamless-m4t-large-v2",
                                        "audio_frames")])
def test_launcher_names_the_missing_modality(arch, name, capsys,
                                             monkeypatch):
    """The launcher passes no modality, as JAX's does: the VLM and the
    encoder-decoder initialize, then the first prefill raises a
    ``ValueError`` naming the input (JAX's launcher fails there too, on
    the missing stream)."""
    args = ["--arch", arch, "--reduced", "--requests", "2",
            "--max-new-tokens", "2", "--slots", "2"]
    with pytest.raises(ValueError, match=name):
        tlaunch.main(args + ["--device", "cpu"])
    assert capsys.readouterr().out.startswith(f"[serve] {arch}-smoke")
    from repro.launch import serve as jlaunch
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    with pytest.raises((AttributeError, TypeError)):
        jlaunch.main()
