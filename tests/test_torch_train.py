"""The port's training path (``repro_torch.train``, ``dist.grad_compress``)
against the JAX package, on the CPU, at small widths (2 layers, H = 32,
T <= 24, B <= 6).

Mirrors ``tests/test_train_serve.py`` (``TestOptim``, ``TestCtc`` with the
brute-force alignment check, ``TestLosses``, ``TestGruTraining``) and
``tests/test_cache_and_compression.py::test_compressed_training_parity``,
and puts both packages through the same inputs (weights made by the JAX
package, carried across with ``model_from_numpy``; batches made with
numpy). Tolerances, each stated where it is used:

* the optimizers on identical gradients: a few float32 ulps (the schedule's
  ``pow`` / ``cos`` and the global norm's sum order differ by libraries);
* CTC and the losses: float32 sums in other orders;
* the train step (``make_gru_train_step``): the forward outputs within
  1e-5, which also tells whether a LUT or threshold decision flipped (a
  flip moves an output by a LUT grid step or a threshold, orders of
  magnitude more); loss, gradients and the optimizer state within the
  error BPTT accumulates; the updated parameters within what Adam's first
  step, ``lr * g / (|g| + eps)``, makes of the gradient bound.
"""
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import grad_compress as jgc
from repro.ft import checkpoint as jckpt
from repro.models import gru_rnn as jmodels
from repro.quant import qat as jqat
from repro.train import ctc as jctc
from repro.train import losses as jlosses
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.data.synthetic import batch_stream, gas_batch
from repro_torch.dist import grad_compress as tgc
from repro_torch.ft import checkpoint as tckpt
from repro_torch.models import gru_rnn as tmodels
from repro_torch.quant import qat as tqat
from repro_torch.train import ctc as tctc
from repro_torch.train import losses as tlosses
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer

torch.set_num_threads(1)

U32 = 2.0 ** -24
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves_np(tree):
    return [x.detach().numpy() for x in toptim.tree_leaves(tree)]


def _ulps(a, b):
    """Distance of two float32 arrays in units of the larger's ulp."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a.astype(np.float64) - b) / spacing


# -- optimizers -----------------------------------------------------------

def _param_tree(rng):
    """A tree like a GRU model's: a dict holding a list of NamedTuples."""
    def layer(*shape):
        return {"w": rng.normal(0, 1, shape).astype(np.float32),
                "b": rng.normal(0, 0.1, shape[:1]).astype(np.float32)}
    return {"layers": [layer(6, 4), layer(6, 6)],
            "head": rng.normal(0, 1, (6, 3)).astype(np.float32)}


class TestOptim:
    def test_adam_reduces_quadratic(self):
        params = {"w": torch.tensor([3.0, -2.0])}
        state = toptim.init_adam_state(params)
        cfg = toptim.AdamConfig(schedule=toptim.constant_schedule(0.1))
        for _ in range(120):
            params, state, _ = toptim.adam_update({"w": 2 * params["w"]},
                                                  state, params, cfg)
        assert float(params["w"].abs().max()) < 0.05
        assert state["step"].dtype == torch.int32 and int(state["step"]) == 120

    def test_warmup_cosine_shape_and_values(self):
        sched = toptim.warmup_cosine_schedule(1e-3, 10, 100)
        jsched = joptim.warmup_cosine_schedule(1e-3, 10, 100)
        assert float(sched(0)) == 0.0
        assert abs(float(sched(10)) - 1e-3) < 1e-9
        assert float(sched(100)) < float(sched(50)) < float(sched(10))
        steps = torch.arange(0, 120, dtype=torch.int32)
        # torch's and XLA's float32 cos differ by a few ulps (3 measured)
        assert _ulps(sched(steps).numpy(),
                     jsched(jnp.arange(0, 120, dtype=jnp.int32))).max() <= 4
        assert float(toptim.constant_schedule(3e-4)(steps[5])) == \
            float(joptim.constant_schedule(3e-4)(5))

    def test_clip_norm_applied(self):
        cfg = toptim.AdamConfig(schedule=toptim.constant_schedule(0.0),
                                clip_norm=1.0)
        params = {"w": torch.zeros(4)}
        _, _, m = toptim.adam_update({"w": torch.full((4,), 100.0)},
                                     toptim.init_adam_state(params), params,
                                     cfg)
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    @pytest.mark.parametrize("weight_decay", [0.0, 0.01])
    @pytest.mark.parametrize("clip", [None, 1.0])
    def test_adam_update_matches_jax(self, weight_decay, clip):
        rng = np.random.default_rng(3)
        p0 = _param_tree(rng)
        grads = [_param_tree(rng) for _ in range(6)]
        jcfg = joptim.AdamConfig(
            schedule=joptim.warmup_cosine_schedule(1e-2, 2, 6),
            weight_decay=weight_decay, clip_norm=clip)
        tcfg = toptim.AdamConfig(
            schedule=toptim.warmup_cosine_schedule(1e-2, 2, 6),
            weight_decay=weight_decay, clip_norm=clip)
        jp = jax.tree_util.tree_map(jnp.asarray, p0)
        tp = toptim.tree_map(torch.from_numpy, p0)
        js, ts = joptim.init_adam_state(jp), toptim.init_adam_state(tp)
        for g in grads:
            jp, js, jm = joptim.adam_update(
                jax.tree_util.tree_map(jnp.asarray, g), js, jp, jcfg)
            tp, ts, tm = toptim.adam_update(
                toptim.tree_map(torch.from_numpy, g), ts, tp, tcfg)
            assert sorted(jm) == sorted(tm)
            # a few ulps of each leaf's largest element: the schedule's cos,
            # the bias corrections' pow and the global norm's sum order (so
            # the clip scale) differ by an ulp between the libraries, and
            # mu and nu sum six steps of such terms
            for a, b in zip(_leaves_np((jp, js["mu"], js["nu"])),
                            _tleaves_np((tp, ts["mu"], ts["nu"]))):
                assert (np.abs(a - b) <= 8 * U32 * np.abs(a).max()).all()
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 6
        assert int(js["step"]) == 6

    def test_sgd_update_and_global_norm_match_jax(self):
        rng = np.random.default_rng(4)
        p0 = _param_tree(rng)
        jcfg = joptim.SgdConfig(clip_norm=2.0)
        tcfg = toptim.SgdConfig(clip_norm=2.0)
        jp = jax.tree_util.tree_map(jnp.asarray, p0)
        tp = toptim.tree_map(torch.from_numpy, p0)
        js, ts = joptim.init_sgd_state(jp), toptim.init_sgd_state(tp)
        for _ in range(4):
            g = _param_tree(rng)
            assert _ulps(joptim.global_norm(g),
                         toptim.global_norm(toptim.tree_map(
                             torch.from_numpy, g)).numpy()) <= 2
            jp, js, _ = joptim.sgd_update(
                jax.tree_util.tree_map(jnp.asarray, g), js, jp, jcfg)
            tp, ts, _ = toptim.sgd_update(
                toptim.tree_map(torch.from_numpy, g), ts, tp, tcfg)
        for a, b in zip(_leaves_np((jp, js["vel"])),
                        _tleaves_np((tp, ts["vel"]))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# -- CTC ------------------------------------------------------------------

def _log_probs(rng, t, b, c):
    x = rng.normal(0, 1, (t, b, c)).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))


class TestCtc:
    @pytest.mark.parametrize("seed", range(5))
    def test_matches_bruteforce(self, seed):
        t, c = 5, 3
        lp = _log_probs(np.random.default_rng(seed), t, 1, c)
        got = float(tctc.ctc_loss(_t(lp), torch.tensor([[1, 2]]),
                                  torch.tensor([t]), torch.tensor([2]))[0])
        tot = 0.0
        for path in itertools.product(range(c), repeat=t):
            out, prev = [], None
            for s in path:
                if s != 0 and s != prev:
                    out.append(s)
                prev = s
            if out == [1, 2]:
                tot += np.exp(sum(float(lp[i, 0, path[i]]) for i in range(t)))
        assert got == pytest.approx(-np.log(tot), rel=1e-5)

    def test_loss_and_grad_match_jax(self):
        rng = np.random.default_rng(5)
        t, b, c = 12, 6, 6
        x = rng.normal(0, 1, (t, b, c)).astype(np.float32)
        # a repeated label (no skip), an empty label, inputs shorter than T
        # and one example with no valid alignment
        labels = np.array([[1, 1, 2, 3], [4, 0, 0, 0], [0, 0, 0, 0],
                           [5, 2, 5, 2], [3, 3, 3, 0], [2, 1, 4, 5]],
                          np.int32)
        lab_lens = np.array([4, 1, 0, 4, 3, 4], np.int32)
        in_lens = np.array([12, 9, 7, 12, 10, 3], np.int32)

        def jloss(v):
            lp = jax.nn.log_softmax(v, -1)
            return jctc.ctc_loss(lp, jnp.asarray(labels), jnp.asarray(in_lens),
                                 jnp.asarray(lab_lens))
        jl = np.asarray(jloss(jnp.asarray(x)))
        jg = np.asarray(jax.grad(lambda v: jnp.sum(jloss(v)))(jnp.asarray(x)))
        xt = _t(x).requires_grad_(True)
        tl = tctc.ctc_loss(torch.log_softmax(xt, -1), _t(labels), _t(in_lens),
                           _t(lab_lens))
        tl.sum().backward()
        # logaddexp chains of 12 steps: a few ulps of the loss each
        np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=2e-6)
        np.testing.assert_allclose(xt.grad.numpy()[:, :5], jg[:, :5], rtol=0,
                                   atol=2e-6)
        # the infeasible example (4 labels in 3 frames) keeps the JAX
        # contract: a finite loss of -LOG_EPS. Its gradient is an artefact
        # of LOG_EPS absorbing log 2: JAX's logaddexp derivative then weighs
        # a tie 1 + 1, torch's 1/2 + 1/2 (ROADMAP R18); both are finite
        assert tl[5] == jl[5] == np.float32(1e30)
        assert np.isfinite(xt.grad.numpy()).all()

    def test_second_witness_torch_ctc_loss(self):
        rng = np.random.default_rng(6)
        t, b, c = 16, 5, 7
        lp = _log_probs(rng, t, b, c)
        labels = rng.integers(1, c, (b, 5)).astype(np.int64)
        lab_lens = np.array([5, 3, 1, 0, 4])
        in_lens = np.array([16, 14, 9, 6, 16])
        ours = tctc.ctc_loss(_t(lp), _t(labels), _t(in_lens), _t(lab_lens))
        ref = torch.nn.functional.ctc_loss(
            _t(lp), _t(labels), _t(in_lens), _t(lab_lens), blank=0,
            reduction="none")
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-5)

    def test_greedy_and_edit_distance(self):
        rng = np.random.default_rng(7)
        lp = _log_probs(rng, 20, 4, 5)
        lens = np.array([20, 13, 1, 0], np.int32)
        got = tctc.ctc_greedy_decode(_t(lp), _t(lens)).numpy()
        want = np.asarray(jctc.ctc_greedy_decode(jnp.asarray(lp),
                                                 jnp.asarray(lens)))
        np.testing.assert_array_equal(got, want)
        assert (got[3] == -1).all()
        assert tctc.edit_distance([1, 2, 3], [1, 3]) == 1
        assert tctc.edit_distance([], [1, 2]) == 2
        assert tctc.edit_distance([1, 2], [1, 2]) == 0


# -- losses ---------------------------------------------------------------

class TestLosses:
    def test_ce_uniform(self):
        loss, m = tlosses.softmax_cross_entropy(
            torch.zeros(2, 3, 7), torch.zeros(2, 3, dtype=torch.long),
            z_loss=0.0)
        assert float(loss) == pytest.approx(np.log(7), rel=1e-5)
        assert float(m["tokens"]) == 6.0

    def test_lm_loss_shifts(self):
        tokens = torch.tensor([[1, 2, 3, 1]])
        logits = torch.nn.functional.one_hot(torch.tensor([[2, 3, 1, 0]]),
                                             5).float() * 100.0
        loss, _ = tlosses.lm_loss(logits, tokens, z_loss=0.0)
        assert float(loss) < 1e-3

    def test_r_squared_perfect(self):
        y = torch.arange(10.0)
        assert float(tlosses.r_squared(y, y)) == pytest.approx(1.0)

    def test_losses_match_jax(self):
        rng = np.random.default_rng(8)
        logits = rng.normal(0, 3, (3, 9, 11)).astype(np.float32)
        labels = rng.integers(0, 11, (3, 9)).astype(np.int32)
        mask = (rng.random((3, 9)) > 0.3).astype(np.float32)
        for z in (0.0, 1e-4):
            jl, jm = jlosses.softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
                z_loss=z)
            tl, tm = tlosses.softmax_cross_entropy(
                _t(logits), _t(labels).long(), _t(mask), z_loss=z)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
            assert float(tm["accuracy"]) == float(jm["accuracy"])
        jl, _ = jlosses.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask))
        tl, _ = tlosses.lm_loss(_t(logits), _t(labels).long(), _t(mask))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        pred, target = logits[..., :2], logits[..., 2:4] * 0.5
        jl, jm = jlosses.mse_loss(jnp.asarray(pred), jnp.asarray(target))
        tl, tm = tlosses.mse_loss(_t(pred), _t(target))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(tm["rmse"]), float(jm["rmse"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            float(tlosses.r_squared(_t(pred), _t(target))),
            float(jlosses.r_squared(jnp.asarray(pred), jnp.asarray(target))),
            rtol=1e-5)
        lab = rng.integers(1, 11, (9, 3)).astype(np.int32)
        lens = np.array([3, 0, 2], np.int32)
        ins = np.array([3, 2, 3], np.int32)
        jl, _ = jlosses.ctc_loss_mean(jnp.asarray(logits[:, :3].transpose(
            1, 0, 2)), jnp.asarray(lab[:3]), jnp.asarray(ins),
            jnp.asarray(lens))
        tl, tm = tlosses.ctc_loss_mean(_t(logits[:, :3].transpose(1, 0, 2)),
                                       _t(lab[:3]), _t(ins), _t(lens))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        assert list(tm) == ["ctc"]


# -- the train step -------------------------------------------------------

def _task(kind, theta, h=32):
    if kind == "ctc":
        return jmodels.GruTaskConfig(40, h, 2, 12, theta_x=theta,
                                     theta_h=theta)
    return jmodels.GruTaskConfig(14, h, 2, 1, task="regression",
                                 theta_x=theta, theta_h=theta)


def _port_task(cfg):
    return tmodels.GruTaskConfig(cfg.input_size, cfg.hidden_size,
                                 cfg.num_layers, cfg.output_size, cfg.task,
                                 cfg.theta_x, cfg.theta_h)


def _batch(cfg, t=24, b=6, seed=1):
    rng = np.random.default_rng(seed)
    feats = np.cumsum(rng.normal(0, 0.3, (t, b, cfg.input_size)),
                      0).astype(np.float32)
    if cfg.task == "ctc":
        lab_lens = rng.integers(1, 6, b).astype(np.int32)
        lab_lens[1] = 0                                  # an empty label
        return {"features": feats,
                "labels": rng.integers(1, 12, (b, 6)).astype(np.int32),
                "in_lens": rng.integers(t // 2, t + 1, b).astype(np.int32),
                "lab_lens": lab_lens}
    return {"features": feats,
            "targets": np.sin(feats[..., :1]).astype(np.float32)}


def _jloss(cfg, qat, use_delta):
    def loss_fn(params, batch):
        out, _ = jmodels.gru_model_forward(params, cfg, batch["features"],
                                           use_delta=use_delta, qat=qat)
        if cfg.task == "ctc":
            return jlosses.ctc_loss_mean(out, batch["labels"],
                                         batch["in_lens"],
                                         batch["lab_lens"])[0], out
        return jlosses.mse_loss(out, batch["targets"])[0], out
    return loss_fn


def _tgrads(tp, tcfg, qat, use_delta, tb):
    params = toptim.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    out, _ = tmodels.gru_model_forward(params, tcfg, tb["features"],
                                       use_delta=use_delta, qat=qat)
    if tcfg.task == "ctc":
        loss = tlosses.ctc_loss_mean(out, tb["labels"], tb["in_lens"],
                                     tb["lab_lens"])[0]
    else:
        loss = tlosses.mse_loss(out, tb["targets"])[0]
    loss.backward()
    return out.detach(), [p.grad for p in toptim.tree_leaves(params)]


def adam_first_step_bound(g, delta, scale, lr=LR, eps=1e-8):
    """How far Adam's first update ``lr * c g / (|c g| + eps)`` (``c`` the
    clip scale) can move when ``g`` moves by ``delta``: the update is
    monotone in ``g``, so the worst case is at the ends of
    ``[g - delta, g + delta]``; plus 8 ulps of ``lr`` for the bias
    corrections' rounding."""
    def upd(v):
        v = scale * np.asarray(v, np.float64)
        return v / (np.abs(v) + eps)
    u = upd(g)
    reach = np.maximum(np.abs(upd(g + delta) - u), np.abs(upd(g - delta) - u))
    return lr * (reach + 8 * U32)


STEP_CASES = [(k, q, th, True) for k in ("ctc", "regression")
              for q in ("FP32", "EDGEDRNN_QAT") for th in (0.0, 0.25)]
STEP_CASES += [("ctc", "FP32", 0.0, False)]       # the dense pretrain stage


@pytest.mark.parametrize("kind,qat,theta,use_delta", STEP_CASES)
def test_gru_train_step_matches_jax(kind, qat, theta, use_delta):
    cfg = _task(kind, theta)
    jp = jmodels.init_gru_model(jax.random.PRNGKey(0), cfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    tcfg = _port_task(cfg)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    jq, tq = getattr(jqat, qat), getattr(tqat, qat)
    (jl, jout), jg = jax.jit(jax.value_and_grad(_jloss(cfg, jq, use_delta),
                                                has_aux=True))(jp, jb)
    tout, tg = _tgrads(tp, tcfg, tq, use_delta, tb)
    # forward outputs: float32 sums in other orders over T steps; a LUT or
    # threshold decision that flipped would move an output by far more
    out_err = float(np.abs(tout.numpy() - np.asarray(jout)).max())
    assert out_err <= 1e-5, (
        f"outputs differ by {out_err:.3e}: a rounding or threshold "
        "decision flipped between the packages (ROADMAP R17)")

    jstep = jtrainer.make_gru_train_step(
        cfg, joptim.AdamConfig(schedule=joptim.constant_schedule(LR)),
        qat=jq, use_delta=use_delta)
    tstep = ttrainer.make_gru_train_step(
        tcfg, toptim.AdamConfig(schedule=toptim.constant_schedule(LR)),
        qat=tq, use_delta=use_delta)
    js, jm = jstep(jtrainer.init_train_state(jp), jb)
    ts, tm = tstep(ttrainer.init_train_state(tp), tb)
    assert sorted(jm) == sorted(tm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-6)
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=2e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert float(tm["lr"]) == float(jm["lr"])
    assert ts.step.dtype == torch.int32 and int(ts.step) == 1
    # gradients: BPTT over 24 steps sums each leaf's terms in other orders;
    # 2e-5 of the leaf's largest gradient (2e-6 measured at worst)
    scale = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
    for a, b, pj, pt, mu in zip(_leaves_np(jg), tg,
                                _leaves_np(js.params),
                                toptim.tree_leaves(ts.params),
                                toptim.tree_leaves(ts.opt["mu"])):
        delta = 2e-5 * np.abs(a).max()
        assert np.abs(b.numpy() - a).max() <= delta
        # the optimizer state: mu = (1 - b1) c g
        assert (np.abs(mu.numpy() - 0.1 * scale * a)
                <= 0.1 * scale * delta * (1 + 1e-5) + 8 * U32 * np.abs(mu.numpy())
                ).all()
        bound = adam_first_step_bound(a, delta, scale)
        assert (np.abs(pt.numpy() - pj) <= bound + np.spacing(np.abs(pj))
                ).all()


@pytest.mark.parametrize("kind,qat,theta", [("ctc", "EDGEDRNN_QAT", 0.25),
                                            ("regression", "FP32", 0.05)])
def test_train_loop_histories_match_jax(kind, qat, theta):
    cfg = _task(kind, theta)
    jp = jmodels.init_gru_model(jax.random.PRNGKey(0), cfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    batches = [_batch(cfg, t=24, b=4, seed=s) for s in range(5)]
    jstep = jtrainer.make_gru_train_step(
        cfg, joptim.AdamConfig(schedule=joptim.constant_schedule(LR)),
        qat=getattr(jqat, qat))
    tstep = ttrainer.make_gru_train_step(
        _port_task(cfg),
        toptim.AdamConfig(schedule=toptim.constant_schedule(LR)),
        qat=getattr(tqat, qat))
    seen = []
    _, jh = jtrainer.train_loop(
        jstep, jtrainer.init_train_state(jp),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], 5)
    ts, th = ttrainer.train_loop(
        tstep, ttrainer.init_train_state(tp),
        [{k: _t(v) for k, v in b.items()} for b in batches], 5,
        ttrainer.LoopHooks(on_step=lambda i, m: seen.append(i),
                           checkpoint_every=2,
                           save_checkpoint=lambda i, s: seen.append(
                               ("ckpt", i, int(s.step)))))
    assert seen == [0, 1, ("ckpt", 2, 2), 2, 3, ("ckpt", 4, 4), 4]
    assert [sorted(h) for h in th] == [sorted(h) for h in jh]
    # five Adam steps, each a near-sign update of gradients that agree to
    # ~1e-6: the losses stay within 1e-4 of each other
    for a, b in zip(jh, th):
        assert all(isinstance(v, float) for v in b.values())
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
    assert int(ts.step) == 5


def test_gas_regression_converges():
    # tests/test_train_serve.py::TestGruTraining, on the port
    task = tmodels.GruTaskConfig(14, 32, 2, 1, task="regression",
                                 theta_x=0.05, theta_h=0.05)
    params = tmodels.init_gru_model(0, task, device="cpu")
    step = ttrainer.make_gru_train_step(
        task, toptim.AdamConfig(schedule=toptim.constant_schedule(3e-3)))
    stream = batch_stream(gas_batch, 1, batch=8, t_len=64, device="cpu")
    _, hist = ttrainer.train_loop(step, ttrainer.init_train_state(params),
                                  stream, 25)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.3


def test_delta_vs_dense_training_parity():
    losses = {}
    for name, (tx, ud) in {"dense": (0.0, False),
                           "delta": (0.05, True)}.items():
        task = tmodels.GruTaskConfig(14, 24, 1, 1, task="regression",
                                     theta_x=tx, theta_h=tx)
        params = tmodels.init_gru_model(0, task, device="cpu")
        step = ttrainer.make_gru_train_step(
            task, toptim.AdamConfig(schedule=toptim.constant_schedule(3e-3)),
            use_delta=ud)
        stream = batch_stream(gas_batch, 1, batch=8, t_len=48, device="cpu")
        _, hist = ttrainer.train_loop(step, ttrainer.init_train_state(params),
                                      stream, 25)
        losses[name] = hist[-1]["loss"]
    assert losses["delta"] < losses["dense"] * 2.0 + 0.2


# -- gradient compression -------------------------------------------------

@pytest.mark.parametrize("mode", ["theta", "quantile", "disabled"])
def test_compress_matches_jax_and_telescopes(mode):
    rng = np.random.default_rng(9)
    kw = {"theta": {"theta": 0.5}, "quantile": {"quantile": 0.8},
          "disabled": {"enabled": False}}[mode]
    jcfg, tcfg = jgc.CompressionConfig(**kw), tgc.CompressionConfig(**kw)
    first = _param_tree(rng)
    jres = jgc.init_residual(jax.tree_util.tree_map(jnp.asarray, first))
    tres = tgc.init_residual(toptim.tree_map(torch.from_numpy, first))
    sent_sum = toptim.tree_map(lambda g: np.zeros(g.shape), first)
    grad_sum = toptim.tree_map(lambda g: np.zeros(g.shape), first)
    for _ in range(4):
        g = _param_tree(rng)
        tg = toptim.tree_map(torch.from_numpy, g)
        js, jres, jst = jgc.compress(jax.tree_util.tree_map(jnp.asarray, g),
                                     jres, jcfg)
        before = tres
        ts, tres, tst = tgc.compress(tg, tres, tcfg)
        # the same threshold (quantile: JAX's linear interpolation) and the
        # same elements sent, exactly
        assert float(tst["threshold"]) == float(jst["threshold"])
        assert float(tst["fired_fraction"]) == float(jst["fired_fraction"])
        for a, b in zip(_leaves_np((js, jres)), _tleaves_np((ts, tres))):
            np.testing.assert_array_equal(a, b)
        if mode != "disabled":
            # each step: sent + new residual == grads + old residual, bitwise
            for s, r, gg, r0 in zip(*(toptim.tree_leaves(x)
                                      for x in (ts, tres, tg, before))):
                assert torch.equal(s + r, gg + r0)
        sent_sum = toptim.tree_map(lambda a, s: a + s.double().numpy(),
                                   sent_sum, ts)
        grad_sum = toptim.tree_map(lambda a, s: a + s.double().numpy(),
                                   grad_sum, tg)
    if mode != "disabled":
        # no gradient mass lost: sum(sent) + residual == sum(grads)
        for s, r, gsum in zip(*(toptim.tree_leaves(x)
                                for x in (sent_sum, tres, grad_sum))):
            np.testing.assert_allclose(s + r.double().numpy(), gsum,
                                       rtol=0, atol=1e-5)


def test_compressed_training_parity():
    # tests/test_cache_and_compression.py::test_compressed_training_parity
    task = tmodels.GruTaskConfig(14, 24, 1, 1, task="regression")
    params = tmodels.init_gru_model(0, task, device="cpu")
    opt = toptim.AdamConfig(schedule=toptim.constant_schedule(3e-3))

    def loss_fn(p, batch):
        out, _ = tmodels.gru_model_forward(p, task, batch["features"])
        return tlosses.mse_loss(out, batch["targets"])[0]

    def run(theta):
        cfg = tgc.CompressionConfig(theta=theta, enabled=theta > 0)
        residual = tgc.init_residual(params)
        state = ttrainer.init_train_state(params)
        losses, fired = [], []
        stream = batch_stream(gas_batch, 1, batch=8, t_len=48, device="cpu")
        for _ in range(30):
            batch = next(stream)
            p = toptim.tree_map(lambda x: x.detach().requires_grad_(True),
                                state.params)
            loss_fn(p, batch).backward()
            grads = toptim.tree_map(lambda x: x.grad, p)
            sent, residual, stats = tgc.compress(grads, residual, cfg)
            new_p, new_o, _ = toptim.adam_update(sent, state.opt,
                                                 state.params, opt)
            state = ttrainer.TrainState(new_p, new_o)
            fired.append(float(stats["fired_fraction"]))
            with torch.no_grad():
                losses.append(float(loss_fn(state.params, batch)))
        return losses, float(np.mean(fired))

    dense_losses, _ = run(0.0)
    comp_losses, fired_frac = run(2e-4)
    assert fired_frac < 0.9            # real wire savings
    assert comp_losses[-1] < dense_losses[0]
    assert comp_losses[-1] < dense_losses[-1] * 2.5 + 0.1


# -- TrainState checkpoints across the packages ---------------------------

def _manifest_entries(path):
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        return [(e["path"], e["shape"], e["dtype"])
                for e in json.load(f)["leaves"]]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_train_state_checkpoint_across_packages(writer, tmp_path):
    cfg = _task("ctc", 0.25)
    jp = jmodels.init_gru_model(jax.random.PRNGKey(0), cfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    tcfg = _port_task(cfg)
    batches = [_batch(cfg, t=16, b=3, seed=s) for s in range(3)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tb = [{k: _t(v) for k, v in b.items()} for b in batches]
    jstep = jtrainer.make_gru_train_step(
        cfg, joptim.AdamConfig(), qat=jqat.EDGEDRNN_QAT)
    tstep = ttrainer.make_gru_train_step(
        tcfg, toptim.AdamConfig(), qat=tqat.EDGEDRNN_QAT)
    jstate, tstate = jtrainer.init_train_state(jp), ttrainer.init_train_state(
        tp)
    for i in range(2):
        jstate, _ = jstep(jstate, jb[i])
        tstate, _ = tstep(tstate, tb[i])
    jckpt.save(str(tmp_path / "j"), 2, jstate)
    tckpt.save(str(tmp_path / "t"), 2, tstate)
    # the two manifests name the same leaves, leaf path for leaf path, with
    # the step an int32 scalar
    jm = _manifest_entries(str(tmp_path / "j" / "step_00000002"))
    assert jm == _manifest_entries(str(tmp_path / "t" / "step_00000002"))
    assert (".opt/step", [], "int32") in jm
    if writer == "jax":
        # the JAX checkpoint into the port: leaves bitwise, and the port
        # continues from it exactly as from the same values in memory
        got = tckpt.restore(str(tmp_path / "j"), tstate, device="cpu")
        for a, b in zip(_leaves_np(jstate), _tleaves_np(got)):
            np.testing.assert_array_equal(a, b)
        assert got.step.dtype == torch.int32
        mem = toptim.tree_map(lambda _, a: _t(np.asarray(a)), tstate, jstate)
        a, _ = tstep(got, tb[2])
        b, _ = tstep(mem, tb[2])
        for x, y in zip(_tleaves_np(a), _tleaves_np(b)):
            np.testing.assert_array_equal(x, y)
    else:
        got = jckpt.restore(str(tmp_path / "t"), jstate)
        for a, b in zip(_leaves_np(got), _tleaves_np(tstate)):
            np.testing.assert_array_equal(a, b)
        assert got.opt["step"].dtype == jnp.int32
        mem = toptim.tree_map(lambda _, t: jnp.asarray(t.numpy()), jstate,
                              tstate)
        a, _ = jstep(got, jb[2])
        b, _ = jstep(mem, jb[2])
        for x, y in zip(_leaves_np(a), _leaves_np(b)):
            np.testing.assert_array_equal(x, y)
