"""The port's QAT policy (``repro_torch.quant.qat``) and the activation
arguments of its cells against the JAX package, on the CPU, at small
widths (2 layers, H = 32).

Mirrors ``tests/test_quant.py`` (STE and LUT gradients, QAT DeltaGRU close
to fp32) and adds the parity the port owes:

* the policies, ``quantize_params`` over a ``GruLayerParams`` and
  ``quantize_act``: bitwise;
* the QAT DeltaGRU step in lockstep (both packages fed the port's state
  each step, the JAX side through its public ``deltagru_step`` with its own
  LUTs), at θ = 0 and θ > 0. The LUT's argument is a float32 sum, summed in
  another order by each library, so one ulp can move a LUT output a whole
  grid step. The test does not avoid that: the arguments must agree within
  the rounding-error bound of their sums, every output must be equal except
  where an argument lies within that bound of a LUT rounding boundary, and
  the flagged sites and the flips are counted;
* every kernel backend of both cells refuses custom activations, as in
  JAX, and ``dense`` honours them.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deltagru as jgru
from repro.core import deltalstm as jlstm
from repro.models import gru_rnn as jmodels
from repro.quant import qat as jqat
from repro_torch.core import deltagru as tgru
from repro_torch.core import deltalstm as tlstm
from repro_torch.core.program import compile_deltagru
from repro_torch.models import gru_rnn as tmodels
from repro_torch.quant import lut as tlut
from repro_torch.quant import qat as tqat
# the package re-exports the function fake_quant under the module's name
# (as repro.quant does), so the module is imported by its full name
tfq = importlib.import_module("repro_torch.quant.fake_quant")

jfq = importlib.import_module("repro.quant.fake_quant")
torch.set_num_threads(1)

U32 = 2.0 ** -24     # float32 unit roundoff
KERNEL_BACKENDS = ["fused", "fused_q8", "fused_q4", "fused_batch",
                   "fused_q8_batch", "fused_q4_batch"]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _models(cfg, seed=0):
    jp = jmodels.init_gru_model(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tmodels.model_from_numpy(tree, device="cpu")


def _frames(t, b, i, seed=1):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 0.3, (t, b, i)), 0).astype(np.float32)


# -- flip accounting (shared with test_torch_train.py) -------------------

def lut_flagged(arg, delta, fn: str, frac_bits: int = 4) -> np.ndarray:
    """Sites where a LUT output may legitimately differ between the
    packages: the exact function over ``[arg - delta, arg + delta]`` (the
    port's argument and the bound on its difference from the JAX one),
    widened by the two libraries' own difference at ``arg``, reaches a
    rounding boundary of the ``Q1.frac_bits`` output grid."""
    a = np.asarray(arg, np.float32)
    tfn = {"sigmoid": torch.sigmoid, "tanh": torch.tanh}[fn]
    jfn = {"sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh}[fn]
    e_t = tfn(torch.from_numpy(a)).numpy().astype(np.float64)
    e_j = np.asarray(jfn(jnp.asarray(a)), np.float64)
    slope = e_t * (1 - e_t) if fn == "sigmoid" else 1 - e_t ** 2
    reach = np.abs(slope) * np.asarray(delta, np.float64) + 2 * U32
    scale = 2.0 ** frac_bits
    lo = (np.minimum(e_t, e_j) - reach) * scale - 0.5
    hi = (np.maximum(e_t, e_j) + reach) * scale - 0.5
    return np.floor(lo) != np.floor(hi)


def sum_bound(absum, n_terms: int) -> np.ndarray:
    """Bound on the difference of two float32 sums of the same ``n_terms``
    terms added in different orders, whose absolute values add to
    ``absum``: each order is within ``(n - 1) u absum`` of the exact sum."""
    return 2 * n_terms * U32 * np.asarray(absum, np.float64)


def gru_step_bounds(p, st, dx, dh):
    """Per-element bound on |ΔM| of one DeltaGRU layer step (the LUT
    arguments ``m_r``, ``m_u``; ``m_xc``, ``m_hc`` of the candidate), from
    the absolute values the port summed. ``p`` and ``st`` are the port's
    (fake-quantized) layer and state, ``dx`` / ``dh`` its deltas."""
    f64 = lambda t: t.detach().numpy().astype(np.float64)  # noqa: E731
    zx = np.abs(f64(dx)) @ np.abs(f64(p.w_x)).T
    zh = np.abs(f64(dh)) @ np.abs(f64(p.w_h)).T
    h = zh.shape[-1] // 3
    m = np.abs(f64(st.m))
    i_dim, h_dim = p.input_size, p.hidden_size
    n = i_dim + h_dim + 2
    b_r = sum_bound(m[..., :h] + zx[..., :h] + zh[..., :h], n)
    b_u = sum_bound(m[..., h:2 * h] + zx[..., h:2 * h] + zh[..., h:2 * h], n)
    b_xc = sum_bound(m[..., 2 * h:3 * h] + zx[..., 2 * h:], i_dim + 1)
    b_hc = sum_bound(m[..., 3 * h:] + zh[..., 2 * h:], h_dim + 1)
    return b_r, b_u, b_xc, b_hc


def _jstate(st):
    """The JAX layer state holding the port's values."""
    a = lambda t: jnp.asarray(t.detach().numpy())  # noqa: E731
    from repro.core.delta import DeltaState as JDeltaState
    return jgru.DeltaGruLayerState(h=a(st.h),
                                   x_mem=JDeltaState(a(st.x_mem.memory)),
                                   h_mem=JDeltaState(a(st.h_mem.memory)),
                                   m=a(st.m))


# -- policies -------------------------------------------------------------

@pytest.mark.parametrize("name", ["FP32", "EDGEDRNN_QAT", "EDGEDRNN_QAT_W4"])
def test_policies_match(name):
    j, t = getattr(jqat, name), getattr(tqat, name)
    for f in ("enabled", "lut_frac_bits", "weight_bits"):
        assert getattr(j, f) == getattr(t, f)
    for f in ("weight_fmt", "act_fmt"):
        jf, tf = getattr(j, f), getattr(t, f)
        assert (jf.int_bits, jf.frac_bits) == (tf.int_bits, tf.frac_bits)
    assert tqat.QatPolicy.for_weight_bits(8) == tqat.EDGEDRNN_QAT
    with pytest.raises(ValueError, match="no weight grid"):
        tqat.QatPolicy.for_weight_bits(5)
    sig, tanh = tqat.FP32.act_fns()
    assert sig is torch.sigmoid and tanh is torch.tanh


@pytest.mark.parametrize("name", ["EDGEDRNN_QAT", "EDGEDRNN_QAT_W4", "FP32"])
def test_quantize_params_and_act_bitwise(name):
    cfg = jmodels.GruTaskConfig(40, 32, 2, 12)
    jp, tp = _models(cfg)
    j, t = getattr(jqat, name), getattr(tqat, name)
    for jl, tl in zip(jp["gru"], tp["gru"]):
        tq = t.quantize_params(tl)
        assert isinstance(tq, tgru.GruLayerParams)
        for a, b in zip(jax.tree_util.tree_leaves(j.quantize_params(jl)), tq):
            _eq(a, b.numpy())
    x = np.random.default_rng(2).normal(0, 40, 4096).astype(np.float32)
    _eq(j.quantize_act(jnp.asarray(x)), t.quantize_act(torch.from_numpy(x)))


def test_ste_gradient_is_identity():
    # tests/test_quant.py::TestQFormat::test_ste_gradient_is_identity
    x = torch.tensor([0.3, -0.5], requires_grad=True)
    (tfq.fake_quant(x, tfq.WGT_Q17) * 3.0).sum().backward()
    g = jax.grad(lambda v: jnp.sum(jfq.fake_quant(v, jfq.WGT_Q17) * 3.0))(
        jnp.array([0.3, -0.5]))
    _eq(x.grad.numpy(), g)
    _eq(x.grad.numpy(), [3.0, 3.0])
    # through a whole layer: the gradient of the fake-quantized weights is
    # the gradient of the weights
    w = torch.randn(6, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    tqat.EDGEDRNN_QAT.quantize_params(w).sum().backward()
    _eq(w.grad.numpy(), np.ones((6, 4), np.float32))


@pytest.mark.parametrize("fn", ["sigmoid", "tanh"])
def test_lut_gradient_is_exact_function(fn):
    # tests/test_quant.py::TestLut, through the policy's act fns
    x = np.linspace(-4, 4, 257).astype(np.float32)
    k = 0 if fn == "sigmoid" else 1
    tf, jf = tqat.EDGEDRNN_QAT.act_fns()[k], jqat.EDGEDRNN_QAT.act_fns()[k]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tf(xt)
    y.sum().backward()
    yj, gj = jax.value_and_grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(x))
    scaled = y.detach().numpy() * 16
    _eq(scaled, np.round(scaled))                       # on the Q1.4 grid
    flagged = lut_flagged(x, 0.0, fn)
    _eq(y.detach().numpy()[~flagged], np.asarray(jf(jnp.asarray(x)))[~flagged])
    # the exact gradients, 1 - tanh^2 or s (1 - s): the two libraries'
    # sigmoid/tanh differ by up to 2.4e-7 (ROADMAP R2), moved twice by the
    # square's cancellation near 1
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=2 * 2.4e-7 + 2 * U32)
    assert (np.diff(y.detach().numpy()) >= 0).all()     # monotone
    assert tlut.lut_sigmoid(4).table(tfq.QFormat(3, 4)).shape == (256,)


# -- the QAT DeltaGRU step, in lockstep -----------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.25])
def test_qat_deltagru_lockstep_counts_flips(theta, record_property):
    cfg = jmodels.GruTaskConfig(40, 32, 2, 12)
    jp, tp = _models(cfg)
    xs = _frames(48, 8, 40)
    qt = [tqat.EDGEDRNN_QAT.quantize_params(p) for p in tp["gru"]]
    qj = [jqat.EDGEDRNN_QAT.quantize_params(p) for p in jp["gru"]]
    ts, tt = tqat.EDGEDRNN_QAT.act_fns()
    js, jt = jqat.EDGEDRNN_QAT.act_fns()
    state = [tgru.init_deltagru_state(p, (8,)) for p in qt]
    flagged = flips = sites = 0
    for x in xs:
        inp = torch.from_numpy(x)
        for li in range(2):
            st = state[li]
            out_t = tgru.deltagru_step(qt[li], st, inp, theta, theta,
                                       sigmoid=ts, tanh=tt)
            out_j = jgru.deltagru_step(qj[li], _jstate(st),
                                       jnp.asarray(inp.numpy()), theta, theta,
                                       sigmoid=js, tanh=jt)
            # the deltas and memories come from the same inputs: bitwise
            for a, b in ((out_j.delta_x, out_t.delta_x),
                         (out_j.delta_h, out_t.delta_h),
                         (out_j.state.x_mem.memory, out_t.state.x_mem.memory),
                         (out_j.state.h_mem.memory, out_t.state.h_mem.memory)):
                _eq(a, b.numpy())
            # the LUT arguments: within the bound of their sums
            b_r, b_u, b_xc, b_hc = gru_step_bounds(
                qt[li], st, out_t.delta_x, out_t.delta_h)
            m_t = out_t.state.m.numpy().astype(np.float64)
            m_j = np.asarray(out_j.state.m, np.float64)
            bound = np.concatenate([b_r, b_u, b_xc, b_hc], -1)
            assert (np.abs(m_t - m_j) <= bound).all()
            # outputs: equal except where an argument lies within its bound
            # of a LUT rounding boundary
            mr, mu, mxc, mhc = np.split(out_t.state.m.numpy(), 4, -1)
            r = ts(torch.from_numpy(mr)).numpy()
            c_arg = mxc + r * mhc
            b_c = b_xc + np.abs(r) * b_hc + U32 * np.abs(c_arg)
            site = np.stack([lut_flagged(mr, b_r, "sigmoid"),
                             lut_flagged(mu, b_u, "sigmoid"),
                             lut_flagged(c_arg, b_c, "tanh")])
            differs = out_t.h.numpy() != np.asarray(out_j.h)
            assert not (differs & ~site.any(0)).any(), (
                "an output differs where no argument is near a boundary")
            flagged += int(site.sum())
            flips += int(differs.sum())
            sites += site.size
            state[li] = out_t.state
            inp = out_t.h
    record_property("lut_sites", sites)
    record_property("flagged_sites", flagged)
    record_property("flips", flips)
    print(f"theta={theta}: {sites} LUT sites, {flagged} within the bound of "
          f"a rounding boundary, {flips} outputs flipped")
    assert flips <= flagged


def test_qat_deltagru_close_to_fp32():
    # tests/test_quant.py::TestQatPolicy::test_qat_deltagru_close_to_fp32,
    # and the port's QAT forward equal to JAX's on the same inputs
    cfg = jmodels.GruTaskConfig(8, 16, 1, 2, theta_x=0.0, theta_h=0.0)
    jp, tp = _models(cfg)
    tcfg = tmodels.GruTaskConfig(8, 16, 1, 2)
    xs = (0.5 * np.sin(np.arange(20.0))[:, None, None]
          * np.ones((20, 2, 8))).astype(np.float32)
    y_fp, _ = tmodels.gru_model_forward(tp, tcfg, torch.from_numpy(xs))
    y_q, _ = tmodels.gru_model_forward(tp, tcfg, torch.from_numpy(xs),
                                       qat=tqat.EDGEDRNN_QAT)
    assert float((y_fp - y_q).abs().max()) < 0.25
    jy_q, _ = jmodels.gru_model_forward(jp, cfg, jnp.asarray(xs),
                                        qat=jqat.EDGEDRNN_QAT)
    np.testing.assert_allclose(y_q.numpy(), np.asarray(jy_q), rtol=0,
                               atol=1e-6)
    jy_o = jmodels.gru_model_forward(jp, cfg, jnp.asarray(xs),
                                     use_delta=False, qat=jqat.EDGEDRNN_QAT)[0]
    ty_o = tmodels.gru_model_forward(tp, tcfg, torch.from_numpy(xs),
                                     use_delta=False,
                                     qat=tqat.EDGEDRNN_QAT)[0]
    np.testing.assert_allclose(ty_o.numpy(), np.asarray(jy_o), rtol=0,
                               atol=1e-6)


def test_program_refuses_qat():
    cfg = tmodels.GruTaskConfig(40, 32, 2, 12)
    _, tp = _models(jmodels.GruTaskConfig(40, 32, 2, 12))
    prog = compile_deltagru(tp, "fused_q8", device="cpu")
    xs = torch.zeros(2, 1, 40)
    with pytest.raises(ValueError, match="QAT fake quant"):
        tmodels.gru_model_forward(tp, cfg, xs, program=prog,
                                  qat=tqat.EDGEDRNN_QAT)
    with pytest.raises(ValueError, match="plain-GRU oracle"):
        tmodels.gru_model_forward(tp, cfg, xs, program=prog, use_delta=False)


# -- kernel backends refuse custom activations, dense honours them ---------

def _lstm_models():
    cfg = jmodels.GruTaskConfig(40, 32, 2, 12)
    jp = jmodels.init_lstm_model(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tmodels.model_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_kernel_backends_refuse_custom_acts(cell, backend):
    jp, tp = (_models(jmodels.GruTaskConfig(40, 32, 2, 12)) if cell == "gru"
              else _lstm_models())
    tmod = tgru if cell == "gru" else tlstm
    init_t = (tgru.init_deltagru_state if cell == "gru"
              else tlstm.init_deltalstm_state)
    init_j = (jgru.init_deltagru_state if cell == "gru"
              else jlstm.init_deltalstm_state)
    step_t = tgru.deltagru_step if cell == "gru" else tlstm.deltalstm_step
    step_j = jgru.deltagru_step if cell == "gru" else jlstm.deltalstm_step
    tl, jl = tp[cell][0], jp[cell][0]
    x = np.ones((2, 40), np.float32)
    want = ("hard-codes the Q8.8/Q1.n LUT" if "q" in backend
            else "hard-codes the")
    for sig, tanh in ((tlut.lut_sigmoid(4), torch.tanh),
                      (torch.sigmoid, tlut.lut_tanh(4)),
                      tqat.EDGEDRNN_QAT.act_fns()):
        with pytest.raises(ValueError, match=want):
            step_t(tl, init_t(tl, (2,)), torch.from_numpy(x), 0.1, 0.1,
                   sigmoid=sig, tanh=tanh, backend=backend)
    js, jt = jqat.EDGEDRNN_QAT.act_fns()
    with pytest.raises(ValueError, match=want):
        step_j(jl, init_j(jl, (2,)), jnp.asarray(x), 0.1, 0.1, sigmoid=js,
               tanh=jt, backend=backend)
    # the sequence drivers pass them through to the same refusal
    seq = (tgru.deltagru_sequence if cell == "gru"
           else tlstm.deltalstm_sequence)
    with pytest.raises(ValueError, match=want):
        seq(tp[cell], torch.zeros(2, 2, 40), 0.1, 0.1, backend=backend,
            sigmoid=tlut.lut_sigmoid(4))
    # default activations, named or not, run the kernel's plain version
    out = step_t(tl, init_t(tl, (2,), m_init=tmod.get_backend(
        backend, cell=cell).m_init), torch.from_numpy(x), 0.1, 0.1,
        sigmoid=torch.sigmoid, tanh=torch.tanh, backend=backend)
    assert torch.isfinite(out.h).all()


def test_dense_honours_custom_acts():
    """The LSTM twin in lockstep (the GRU's is above): the port's dense
    step with the QAT LUTs against JAX's, each step from the port's state;
    outputs equal except where a LUT argument is within the bound of its
    sum of a rounding boundary."""
    jp, tp = _lstm_models()
    xs = _frames(12, 4, 40)
    ts, tt = tqat.EDGEDRNN_QAT.act_fns()
    js, jt = jqat.EDGEDRNN_QAT.act_fns()
    from repro.core.delta import DeltaState as JDeltaState
    a = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    state = [tlstm.init_deltalstm_state(p, (4,)) for p in tp["lstm"]]
    flips = flagged = 0
    for x in xs:
        inp = torch.from_numpy(x)
        for li, (pt, pj) in enumerate(zip(tp["lstm"], jp["lstm"])):
            st = state[li]
            jst = jlstm.DeltaLstmLayerState(
                h=a(st.h), c=a(st.c), x_mem=JDeltaState(a(st.x_mem.memory)),
                h_mem=JDeltaState(a(st.h_mem.memory)), m=a(st.m))
            out_t = tlstm.deltalstm_step(pt, st, inp, 0.1, 0.1, sigmoid=ts,
                                         tanh=tt)
            out_j = jlstm.deltalstm_step(pj, jst, a(inp), 0.1, 0.1,
                                         sigmoid=js, tanh=jt)
            zx = np.abs(out_t.delta_x.numpy()) @ np.abs(pt.w_x.numpy()).T
            zh = np.abs(out_t.delta_h.numpy()) @ np.abs(pt.w_h.numpy()).T
            bound = sum_bound(np.abs(st.m.numpy()) + zx + zh,
                              pt.input_size + pt.hidden_size + 2)
            m_t = out_t.state.m.numpy()
            assert (np.abs(m_t.astype(np.float64)
                           - np.asarray(out_j.state.m, np.float64))
                    <= bound).all()
            mi, mf, mg, mo = np.split(m_t, 4, -1)
            bi, bf, bg, bo = np.split(bound, 4, -1)
            site = np.stack([lut_flagged(mi, bi, "sigmoid"),
                             lut_flagged(mf, bf, "sigmoid"),
                             lut_flagged(mg, bg, "tanh"),
                             lut_flagged(mo, bo, "sigmoid"),
                             lut_flagged(out_t.state.c.numpy(), 0.0, "tanh")])
            differs = out_t.h.numpy() != np.asarray(out_j.h)
            assert not (differs & ~site.any(0)).any()
            flips += int(differs.sum())
            flagged += int(site.sum())
            state[li] = out_t.state
            inp = out_t.h
    assert flips <= flagged
    # dense did run the LUTs: on the Q1.4 grid products, unlike the default
    plain = tlstm.deltalstm_sequence(tp["lstm"], torch.from_numpy(xs),
                                     0.1, 0.1)[0]
    lut = tlstm.deltalstm_sequence(tp["lstm"], torch.from_numpy(xs), 0.1,
                                   0.1, sigmoid=ts, tanh=tt)[0]
    assert float((plain - lut).abs().max()) > 1e-3
