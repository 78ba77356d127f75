"""The LM train step of the PyTorch port against the JAX package, on the
CPU: ``make_lm_train_step`` for all ten archs of the registry at
``cfg.reduced()`` (2-3 layers, D = 64, vocab 128), remat, and two steps on
one batch. ``tests/test_torch_lm_train_loop.py`` holds gradient
accumulation, a gradient transform, ``train_loop``, the data, the
launcher and the scans' autograd guard, with this file's helpers.

Weights come across from JAX's own init through ``lm_params_from_numpy``,
leaf for leaf; the batch (tokens [4, 16], and the VLM's image embeddings /
seamless's audio frames) is made with numpy from a seed and handed to
both packages. One step of each package from the same state. Tolerances:

* ``TOL_METRIC`` = 1e-5 relative for the loss and the metrics but
  ``grad_norm``: float32 sums in other orders through two or three layers
  and a 128-way softmax (measured at most 2.7e-7). ``accuracy`` and
  ``tokens`` are counts: equal.
* ``TOL_GRAD`` = 1e-5 of each gradient leaf's largest magnitude: autograd
  and ``jax.value_and_grad`` sum the same products in other orders
  (measured at most 6.6e-6, recurrentgemma's conv weights); ``grad_norm``
  is held to it too. RWKV6's group norm divides each head by its standard
  deviation, ``rsqrt(var + 1e-5)``, and its backward subtracts near-equal
  terms where a head's variance is small (R12): its leaves are held to
  ``TOL_GRAD_RWKV6`` = 5e-4, measured at most 1.74e-5 at B = 4 (the
  channel-mix ``mu_r``) and 1.2e-4 on the second microbatch of 2 of the
  ``grad_accum`` test (layer 0's token-shift LoRA and ``norm1``; the
  microbatch's ``grad_norm`` 8.5e-5 apart).
* The parameters after Adam: within ``adam_first_step_bound`` of
  ``TOL_GRAD``, the reach of Adam's first, near-sign update over the
  gradient's interval (a parameter whose gradient is near 0 against
  ``eps`` may move by up to ``lr`` for a gradient error of 1e-5).
* MoE routing is held exactly: the port's router probabilities are
  checked to keep each token's k-th and (k+1)-th choice at least
  ``ROUTE_GAP`` = 1e-6 apart, far from a tie the packages' ulps could
  flip (as ``tests/test_torch_moe_mla.py``).

No parameter leaf of any arch lacks a gradient in either package: the
port's step raises on a leaf without one (none is listed here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.train import losses as jlosses
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.configs import registry as treg
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.train import losses as tlosses
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer

torch.set_num_threads(1)

ARCHS = tuple(jreg.ARCH_IDS)
MOE = ("deepseek-v2-lite-16b", "granite-moe-3b-a800m")
LR = 1e-3
U32 = 2.0 ** -24
TOL_METRIC = 1e-5
TOL_GRAD = 1e-5
TOL_GRAD_RWKV6 = 5e-4
ROUTE_GAP = 1e-6
COUNTS = ("accuracy", "tokens")
B, S = 4, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return tlm.lm_params_from_numpy(_np_tree(tree), device="cpu")


_MODELS = {}


def _model(arch):
    """JAX's reduced model of ``arch`` (seed 0), its weights carried
    across, and a seeded numpy batch, cached for the module."""
    if arch not in _MODELS:
        jcfg = jreg.get_config(arch).reduced()
        tcfg = treg.get_config(arch).reduced()
        jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(len(arch))
        batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(
            np.int32)}
        if jcfg.cross_attn_every:
            batch["image_embeds"] = (rng.normal(0, 1, (
                B, jcfg.n_image_tokens, jcfg.vision_dim)) * 0.02).astype(
                np.float32)
        if jcfg.encdec:
            batch["audio_frames"] = rng.normal(0, 1, (
                B, jcfg.n_audio_frames, jcfg.audio_dim)).astype(np.float32)
        _MODELS[arch] = (jcfg, tcfg, jp, batch)
    jcfg, tcfg, jp, batch = _MODELS[arch]
    return jcfg, tcfg, jp, _port(jp), batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _opt(pkg, **kw):
    return pkg.AdamConfig(schedule=pkg.constant_schedule(LR), **kw)


def _jgrads(jcfg, jp, batch):
    """The JAX step's loss and gradients (``lm_loss`` + 0.01 aux)."""
    def loss_fn(params, b):
        logits, aux = jlm.lm_forward(params, jcfg, b["tokens"],
                                     image_embeds=b.get("image_embeds"),
                                     audio_frames=b.get("audio_frames"))
        return jlosses.lm_loss(logits, b["tokens"])[0] + 0.01 * aux
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp, _jb(batch))
    return float(loss), [np.asarray(g) for g in
                         jax.tree_util.tree_leaves(grads)]


def _tgrads(tcfg, tp, batch):
    """The port's loss and gradients by autograd, in JAX's leaf order."""
    live = toptim.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    tb = _tb(batch)
    logits, aux = tlm.lm_forward(live, tcfg, tb["tokens"],
                                 image_embeds=tb.get("image_embeds"),
                                 audio_frames=tb.get("audio_frames"))
    loss = tlosses.lm_loss(logits, tb["tokens"])[0] + 0.01 * torch.as_tensor(
        aux)
    loss.backward()
    return float(loss.detach()), [p.grad.numpy()
                                  for p in toptim.tree_leaves(live)]


def _tol_grad(arch) -> float:
    return TOL_GRAD_RWKV6 if arch.startswith("rwkv6") else TOL_GRAD


def adam_first_step_bound(g, delta, scale, lr=LR, eps=1e-8, theta=None):
    """How far Adam's first update ``lr * c f(g) / (|c f(g)| + eps)`` (``c``
    the clip scale, ``f`` the identity or, with ``theta``, compression's
    ``where(|g| >= theta, g, 0)``) can move when ``g`` moves by ``delta``:
    the update is monotone in ``g``, so the worst case is at the ends of
    ``[g - delta, g + delta]``; plus 8 ulps of ``lr`` for the bias
    corrections' rounding."""
    def upd(v):
        v = np.asarray(v, np.float64)
        if theta is not None:
            v = np.where(np.abs(v) >= theta, v, 0.0)
        v = scale * v
        return v / (np.abs(v) + eps)
    u = upd(g)
    reach = np.maximum(np.abs(upd(g + delta) - u), np.abs(upd(g - delta) - u))
    return lr * (reach + 8 * U32)


def _metrics_close(tm, jm, tol_grad):
    assert sorted(tm) == sorted(jm) == sorted(
        ["loss", "ce", "accuracy", "tokens", "aux", "grad_norm", "lr"])
    for k, v in tm.items():
        assert isinstance(v, torch.Tensor) and v.shape == () \
            and v.device.type == "cpu", k
        if k in COUNTS:
            assert float(v) == float(jm[k]), k
        else:
            tol = tol_grad if k == "grad_norm" else TOL_METRIC
            np.testing.assert_allclose(float(v), float(jm[k]), rtol=tol,
                                       atol=0, err_msg=k)


def _params_within(ts, js, jg, grad_norm, tol, theta=None):
    """Every updated parameter within Adam's first-step bound of the
    gradient bound ``tol``."""
    scale = min(1.0, 1.0 / (grad_norm + 1e-9))
    for pt, pj, g in zip(toptim.tree_leaves(ts.params),
                         jax.tree_util.tree_leaves(js.params), jg):
        pj = np.asarray(pj)
        bound = adam_first_step_bound(g, tol * np.abs(g).max(), scale,
                                      theta=theta)
        assert pt.dtype == torch.float32
        assert (np.abs(pt.numpy() - pj) <= bound + np.spacing(np.abs(pj))
                ).all()


def _record_routes(monkeypatch) -> list:
    """From here on the port's router calls keep their probabilities and
    choices."""
    calls, orig = [], tmoe._route

    def route(params, xt, k):
        vals, idx, aux = orig(params, xt, k)
        probs = torch.softmax(xt.float() @ params["router"], dim=-1)
        calls.append((probs.detach(), k))
        return vals, idx, aux
    monkeypatch.setattr(tmoe, "_route", route)
    return calls


def _min_route_gap(calls) -> float:
    gaps = [1.0]
    for probs, k in calls:
        p = probs.sort(-1, descending=True).values
        gaps.append(float((p[:, k - 1] - p[:, k]).min()))
    return min(gaps)


# -- one step, every arch -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_jax(arch, monkeypatch):
    """One ``make_lm_train_step`` step of each package from the same state:
    the loss and metrics within ``TOL_METRIC`` (counts equal), each
    gradient leaf within ``TOL_GRAD`` of its largest (``TOL_GRAD_RWKV6``),
    the Adam moments and the updated parameters within what Adam's first
    step makes of that."""
    jcfg, tcfg, jp, tp, batch = _model(arch)
    tol = _tol_grad(arch)
    calls = _record_routes(monkeypatch) if arch in MOE else None
    jloss, jg = _jgrads(jcfg, jp, batch)
    tloss, tg = _tgrads(tcfg, tp, batch)
    np.testing.assert_allclose(tloss, jloss, rtol=TOL_METRIC)
    assert len(tg) == len(jg)
    for a, b in zip(jg, tg):
        assert np.abs(b - a).max() <= tol * np.abs(a).max()

    jstep = jtrainer.make_lm_train_step(jcfg, _opt(joptim), donate=False)
    tstep = ttrainer.make_lm_train_step(tcfg, _opt(toptim))
    js, jm = jstep(jtrainer.init_train_state(jp), _jb(batch))
    ts, tm = tstep(ttrainer.init_train_state(tp), _tb(batch))
    _metrics_close(tm, jm, tol)
    np.testing.assert_allclose(float(tm["loss"]), jloss, rtol=TOL_METRIC)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 1
    _params_within(ts, js, jg, float(jm["grad_norm"]), tol)
    scale = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
    for mu, a in zip(toptim.tree_leaves(ts.opt["mu"]), jg):
        assert mu.dtype == torch.float32        # fp32 moments
        assert (np.abs(mu.numpy() - 0.1 * scale * a)
                <= 0.1 * scale * tol * np.abs(a).max() * (1 + 1e-5)
                + 8 * U32 * np.abs(mu.numpy())).all()
    if arch in MOE:
        assert calls and _min_route_gap(calls) >= ROUTE_GAP
        assert float(tm["aux"]) > 0
    else:
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0


# -- remat --------------------------------------------------------------------

def _count_checkpoints(monkeypatch) -> list:
    calls, orig = [], tblocks.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return orig(fn, *args, **kw)
    monkeypatch.setattr(tblocks, "checkpoint", counting)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_gives_the_same_step(arch, monkeypatch):
    """``remat="full"`` runs each period under ``torch.utils.checkpoint``
    (non-reentrant: one call a period of every schedule, the encoder's
    too) and gives the step of ``remat="none"`` bitwise on the CPU: the
    loss, every metric (the MoE aux loss flows through the checkpoint),
    every parameter and moment. The reduced configs set
    ``remat="none"``."""
    _, tcfg, _, tp, batch = _model(arch)
    assert tcfg.remat == "none"
    full = dataclasses.replace(tcfg, remat="full")
    calls = _count_checkpoints(monkeypatch)
    runs = {}
    for cfg in (tcfg, full):
        n0 = len(calls)
        step = ttrainer.make_lm_train_step(cfg, _opt(toptim))
        runs[cfg.remat] = step(ttrainer.init_train_state(tp), _tb(batch))
        runs[cfg.remat + "_calls"] = calls[n0:]
    periods = sum(count for _, count in tblocks.make_schedule(tcfg))
    if tcfg.encdec:
        periods += tcfg.n_encoder_layers
    assert runs["none_calls"] == []
    assert runs["full_calls"] == [False] * periods
    (sn, mn), (sf, mf) = runs["none"], runs["full"]
    for k in mn:
        assert torch.equal(mn[k], mf[k]), k
    for a, b in zip(toptim.tree_leaves(sn), toptim.tree_leaves(sf)):
        assert torch.equal(a, b)
    if arch in MOE:
        assert float(mf["aux"]) > 0


@pytest.mark.parametrize("arch,n_layers", [("recurrentgemma-9b", 5),
                                           ("llama-3.2-vision-11b", 3)])
def test_remat_full_with_a_remainder_entry(arch, n_layers):
    """A schedule of two entries (the periods, then the layers left over,
    as recurrentgemma-9b's 38 = 12 x 3 + 2 at full size): the checkpoint
    recomputes each period with its own entry's pattern, so the step is
    that of ``remat="none"`` bitwise, and the loss JAX's."""
    jcfg = jreg.get_config(arch).reduced(n_layers=n_layers)
    tcfg = treg.get_config(arch).reduced(n_layers=n_layers)
    assert len(tblocks.make_schedule(tcfg)) == 2
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = tlm.lm_params_from_numpy(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(n_layers)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.cross_attn_every:
        batch["image_embeds"] = (rng.normal(0, 1, (
            B, jcfg.n_image_tokens, jcfg.vision_dim)) * 0.02).astype(
                np.float32)
    runs = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        step = ttrainer.make_lm_train_step(cfg, _opt(toptim))
        runs[remat] = step(ttrainer.init_train_state(tp), _tb(batch))
    (sn, mn), (sf, mf) = runs["none"], runs["full"]
    for k in mn:
        assert torch.equal(mn[k], mf[k]), k
    for a, b in zip(toptim.tree_leaves(sn), toptim.tree_leaves(sf)):
        assert torch.equal(a, b)
    loss, _ = _jgrads(jcfg, jp, batch)
    assert abs(float(mf["loss"]) - loss) <= TOL_METRIC * max(1.0, abs(loss))


def test_remat_stays_off_outside_train_grad():
    """No checkpoint in prefill, or in ``train`` mode without grad."""
    _, tcfg, _, tp, batch = _model("llama3.2-1b")
    full = dataclasses.replace(tcfg, remat="full")
    tb = _tb(batch)
    calls = []
    orig = tblocks.checkpoint
    tblocks.checkpoint = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with torch.no_grad():
            tlm.lm_forward(tp, full, tb["tokens"])
        caches = tlm.init_lm_caches(full, B, 32, device="cpu")
        tlm.lm_prefill(tp, full, tb["tokens"], caches)
    finally:
        tblocks.checkpoint = orig
    assert calls == []


# -- the step and the loop --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_on_one_batch_lower_the_loss(arch):
    """The property of ``tests/test_archs_smoke.py``, on the port's own
    seeded init and ``lm_batch``: two steps (Adam at 1e-3) on one batch,
    finite, and the second loss below the first."""
    from repro_torch.data.lm_data import lm_batch
    tcfg = treg.get_config(arch).reduced()
    params = tlm.init_lm(0, tcfg, device="cpu")
    batch = lm_batch(1, tcfg, 2, 16, device="cpu")
    step = ttrainer.make_lm_train_step(tcfg, _opt(toptim), donate=False)
    state, m1 = step(ttrainer.init_train_state(params), batch)
    state, m2 = step(state, batch)
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"])
