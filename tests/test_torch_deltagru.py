"""The port's DeltaGRU stack, programs, exporter and models against the JAX
package, on the CPU, at small widths (I=40, H in {48, 160}, 2 layers).

Weights go across with ``model_from_numpy``; inputs are made with numpy.
The JAX side runs as its own tests run it: the Pallas bodies in interpret
mode (``program.with_interpret(True)``) at short T, its jnp oracles (the
default off a TPU) over longer sequences.

* int8 / int4 (``fused_q8*`` / ``fused_q4*``): bitwise, at θ = 0 and at
  dual thresholds.
* fp32 (``dense``, ``fused*``): within 1e-5 at θ = 0 (the sums run in
  another order; 1e-5 is the JAX package's own batch-against-solo bound).
  At θ > 0 one ulp can flip a threshold decision and part the
  trajectories, so there both packages are fed the same inputs and state
  each step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deltagru as jgru
from repro.core import program as jprogram
from repro.models import gru_rnn as jmodels
from repro.quant import export as jexport
from repro_torch.configs import edgedrnn as tconfigs
from repro_torch.core import deltagru as tgru
from repro_torch.core import program as tprogram
from repro_torch.core.delta import DeltaState
from repro_torch.models import gru_rnn as tmodels
from repro_torch.quant import export as texport

torch.set_num_threads(1)

QUANT = ["fused_q8", "fused_q4", "fused_q8_batch", "fused_q4_batch"]
FP32 = ["dense", "fused", "fused_batch"]
TOL_F32 = 1e-5


def _models(h, seed=0, bias=True):
    cfg = jmodels.GruTaskConfig(40, h, 2, 12)
    jp = jmodels.init_gru_model(jax.random.PRNGKey(seed), cfg)
    if bias:      # non-zero biases exercise the bias folding / b4 rows
        rng = np.random.default_rng(seed)
        jp["gru"] = [p._replace(b=jnp.asarray(
            rng.normal(0, 0.3, p.b.shape).astype(np.float32)))
            for p in jp["gru"]]
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tmodels.model_from_numpy(tree, device="cpu")


def _frames(t, b, seed=1):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 0.3, (t, b, 40)), 0).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _state_leaves(state):
    out = []
    for layer in state.layers:
        out += [layer.h, layer.x_mem.memory, layer.h_mem.memory, layer.m]
    return out


@pytest.mark.parametrize("backend", QUANT)
@pytest.mark.parametrize("h", [48, 160])
@pytest.mark.parametrize("theta", [(0.0, 0.0), (0.1, 0.2)])
def test_quant_sequences_bitwise_vs_jax_oracle(backend, h, theta):
    jp, tp = _models(h)
    xs = _frames(24, 4)
    jprog = jprogram.compile_deltagru(jp, backend)
    tprog = tprogram.compile_deltagru(tp, backend, device="cpu")
    jy, js, jst = jprog.sequence(jnp.asarray(xs), *theta)
    ty, ts, tst = tprog.sequence(torch.from_numpy(xs), *theta)
    _eq(jy, ty.numpy())
    for a, b in zip(_state_leaves(js), _state_leaves(ts)):
        _eq(a, b.numpy())
    # firing statistics are means of exact 0/1 counts: XLA compiles a mean
    # as a sum times the reciprocal of the count, torch divides
    for (jx, jh), (tx, th) in zip(jst["per_layer"], tst["per_layer"]):
        np.testing.assert_allclose(np.asarray(jx), tx.numpy(), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(jh), th.numpy(), rtol=1e-6)


@pytest.mark.parametrize("backend", ["fused_q8", "fused_q4", "fused"])
def test_sequences_vs_jax_pallas_interpret(backend):
    jp, tp = _models(160)
    xs = _frames(3, 2, seed=7)
    jprog = jprogram.compile_deltagru(jp, backend).with_interpret(True)
    tprog = tprogram.compile_deltagru(tp, backend, device="cpu")
    jy, _, _ = jprog.sequence(jnp.asarray(xs), 0.1, 0.2)
    ty, _, _ = tprog.sequence(torch.from_numpy(xs), 0.1, 0.2)
    if backend == "fused":
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                                   atol=TOL_F32)
    else:
        _eq(jy, ty.numpy())


@pytest.mark.parametrize("backend", FP32)
@pytest.mark.parametrize("h", [48, 160])
def test_fp32_sequences_within_bound_at_theta_zero(backend, h):
    jp, tp = _models(h)
    xs = _frames(24, 4)
    jy, _, jst = jprogram.compile_deltagru(jp, backend).sequence(
        jnp.asarray(xs))
    ty, _, tst = tprogram.compile_deltagru(tp, backend, device="cpu"
                                           ).sequence(torch.from_numpy(xs))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                               atol=TOL_F32)
    assert float(jst["gamma_dx"]) == float(tst["gamma_dx"]) == 0.0


def _torch_state(jstate, tprog, batch):
    """The port's program state holding the JAX state's values."""
    ts = tprog.init_state((batch,))
    layers = []
    for jl, tl in zip(jstate.layers, ts.layers):
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        layers.append(tl._replace(h=t(jl.h), x_mem=DeltaState(t(jl.x_mem.memory)),
                                  h_mem=DeltaState(t(jl.h_mem.memory)),
                                  m=t(jl.m)))
    return tprogram.DeltaProgramState(
        stack=tgru.DeltaGruStackState(tuple(layers)), backend=ts.backend)


@pytest.mark.parametrize("backend", ["fused", "fused_batch", "dense"])
def test_fp32_lockstep_at_dual_theta(backend):
    jp, tp = _models(160)
    xs = _frames(12, 4, seed=3)
    jprog = jprogram.compile_deltagru(jp, backend)
    tprog = tprogram.compile_deltagru(tp, backend, device="cpu")
    js = jprog.init_state((4,))
    for x in xs:
        ts = _torch_state(js, tprog, 4)
        jy, js, _ = jprog.step(js, jnp.asarray(x), 0.1, 0.2)
        ty, ts, _ = tprog.step(ts, torch.from_numpy(x), 0.1, 0.2)
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                                   atol=TOL_F32)
        for a, b in zip(_state_leaves(js), _state_leaves(ts)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=TOL_F32)


def test_gru_oracle_and_theta_zero_identity():
    jp, tp = _models(48)
    xs = _frames(16, 3)
    jy = jgru.gru_sequence(jp["gru"], jnp.asarray(xs))
    ty = tgru.gru_sequence(tp["gru"], torch.from_numpy(xs))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0,
                               atol=TOL_F32)
    dy, _, _ = tgru.deltagru_sequence(tp["gru"], torch.from_numpy(xs),
                                      0.0, 0.0)
    np.testing.assert_allclose(dy.numpy(), ty.numpy(), rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("backend", ["fused", "fused_q8", "fused_q4"])
def test_batched_tile_equals_streams_one_at_a_time(backend):
    _, tp = _models(48)
    xs = torch.from_numpy(_frames(10, 3, seed=4))
    tile = tprogram.compile_deltagru(tp, backend + "_batch", device="cpu")
    solo = tprogram.compile_deltagru(tp, backend, device="cpu")
    ty, _, _ = tile.sequence(xs, 0.1, 0.2)
    for s in range(3):
        sy, _, _ = solo.sequence(xs[:, s:s + 1], 0.1, 0.2)
        if backend == "fused":
            np.testing.assert_allclose(ty[:, s].numpy(), sy[:, 0].numpy(),
                                       rtol=0, atol=TOL_F32)
        else:
            _eq(ty[:, s].numpy(), sy[:, 0].numpy())


def test_batch_backends_reject_streamless_inputs():
    _, tp = _models(48)
    prog = tprogram.compile_deltagru(tp, "fused_q8_batch", device="cpu")
    with pytest.raises(ValueError, match="leading stream axis"):
        prog.step(prog.init_state(()), torch.zeros(40))


def test_kernel_backends_reject_custom_activations():
    # No step option reroutes a kernel backend onto other arithmetic:
    # custom (QAT) activations raise ValueError, as in the JAX package, and
    # a matvec override is not an option of the port's step.
    _, tp = _models(48)
    p = tp["gru"][0]
    st = tgru.init_deltagru_state(p, (1,))
    for be in ("fused", "fused_q8", "fused_q4"):
        for kw in ({"sigmoid": lambda v: v}, {"tanh": lambda v: v}):
            with pytest.raises(ValueError, match="hard-codes the"):
                tgru.deltagru_step(p, st, torch.zeros(1, 40), 0.0, 0.0,
                                   backend=be, **kw)
        with pytest.raises(TypeError, match="unexpected keyword"):
            tgru.deltagru_step(p, st, torch.zeros(1, 40), 0.0, 0.0,
                               backend=be, matvec=lambda w, v: v @ w.T)


# -- programs -----------------------------------------------------------------

def test_program_state_conventions_and_checks():
    _, tp = _models(48)
    q8 = tprogram.compile_deltagru(tp, "fused_q8", device="cpu")
    fp = tprogram.compile_deltagru(tp, "fused", device="cpu")
    assert q8.spec.m_init == "zero" and fp.spec.m_init == "bias"
    assert float(q8.init_state((2,)).layers[0].m.abs().sum()) == 0.0
    assert float(fp.init_state((2,)).layers[0].m.abs().sum()) > 0.0
    with pytest.raises(ValueError, match="silently corrupt"):
        q8.step(fp.init_state((1,)), torch.zeros(1, 40))
    with pytest.raises(TypeError, match="DeltaProgramState"):
        q8.step(q8.init_state((1,)).stack, torch.zeros(1, 40))
    assert q8.with_backend("fused_q8_batch").backend == "fused_q8_batch"
    assert q8.with_backend("fused_q8") is q8
    with pytest.raises(ValueError, match="packs weights differently"):
        q8.with_backend("fused")
    assert (q8.num_layers, q8.input_size, q8.hidden_size) == (2, 40, 48)
    bare = tprogram.compile_deltagru(tp["gru"], "fused", device="cpu")
    with pytest.raises(ValueError, match="bare layer stack"):
        bare.apply_head(torch.zeros(1, 48))
    # the LM cells compile (from their own stacks) and resolve backends
    from repro_torch.core.deltarglru import init_deltarglru_model
    from repro_torch.core.deltarwkv import init_deltarwkv_model
    for cell, init in (("rwkv6", init_deltarwkv_model),
                       ("rglru", init_deltarglru_model)):
        lm = init(0, 64, 1, 12, device="cpu")
        for be in ("dense", "fused"):
            prog = tprogram.compile_delta_program(lm, be, cell=cell,
                                                  device="cpu")
            assert (prog.cell, prog.spec.name, prog.spec.cell) == (
                cell, be, cell)
        with pytest.raises(ValueError, match=f"compile from a {cell!r}"):
            tprogram.compile_delta_program(tp, cell=cell, device="cpu")
    with pytest.raises(ValueError, match="unknown cell"):
        tprogram.compile_delta_program(tp, cell="mamba", device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_delta_model_matches_jax_export(bits):
    jp, tp = _models(160)
    jprog = jexport.quantize_delta_model(jp, bits=bits)
    tprog = texport.quantize_delta_model(tp, bits=bits, device="cpu")
    assert tprog.backend == jprog.backend
    for jl, tl in zip(jprog.layers, tprog.layers):
        for a, b in zip(jl, tl):
            _eq(a, b.numpy())
    for jl, tl in zip(jprog.layouts, tprog.layouts):
        _eq(jl.w_q, tl.w_q.numpy())
    _eq(jprog.head, tprog.head.numpy())
    with pytest.raises(ValueError, match="not a packed runtime width"):
        texport.quantize_delta_model(tp, bits=5, device="cpu")
    with pytest.raises(ValueError, match="'gru' stack"):
        texport.quantize_gru_model({"lstm": tp["gru"]}, device="cpu")


# -- models -------------------------------------------------------------------

def test_paper_networks_and_seeded_init():
    for name, jc in jmodels.PAPER_NETWORKS.items():
        tc = tmodels.PAPER_NETWORKS[name]
        assert (jc.input_size, jc.hidden_size, jc.num_layers,
                jc.output_size, jc.task) == (tc.input_size, tc.hidden_size,
                                             tc.num_layers, tc.output_size,
                                             tc.task)
    assert tconfigs.CONFIG_2L768H == tmodels.PAPER_NETWORKS["2L-768H"]
    cfg = tmodels.GruTaskConfig(40, 48, 2, 12)
    a = tmodels.init_gru_model(3, cfg, device="cpu")
    b = tmodels.init_gru_model(torch.Generator().manual_seed(3), cfg,
                               device="cpu")
    for x, y in zip([*a["gru"][1], a["head"]], [*b["gru"][1], b["head"]]):
        _eq(x.numpy(), y.numpy())
    assert a["gru"][0].w_x.shape == (144, 40)
    assert a["gru"][1].w_x.shape == (144, 48)
    assert a["head"].shape == (48, 12)
    lim = (6.0 / (40 + 144)) ** 0.5
    assert float(a["gru"][0].w_x.abs().max()) <= lim
    assert float(a["head"].abs().max()) <= 2.0 * 48 ** -0.5


@pytest.mark.parametrize("backend", ["fused_q8", "fused"])
def test_gru_model_forward_program_and_dense_paths(backend):
    jp, tp = _models(48)
    cfg_j = jmodels.GruTaskConfig(40, 48, 2, 12, theta_x=0.1, theta_h=0.1)
    cfg_t = tmodels.GruTaskConfig(40, 48, 2, 12, theta_x=0.1, theta_h=0.1)
    xs = _frames(8, 2)
    jo, _ = jmodels.gru_model_forward(
        jp, cfg_j, jnp.asarray(xs),
        program=jprogram.compile_deltagru(jp, backend))
    to, _ = tmodels.gru_model_forward(
        tp, cfg_t, torch.from_numpy(xs),
        program=tprogram.compile_deltagru(tp, backend, device="cpu"))
    # the head is one fp32 matmul whose sum order the libraries choose
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=0,
                               atol=TOL_F32)
    jd, _ = jmodels.gru_model_forward(jp, cfg_j, jnp.asarray(xs),
                                      use_delta=False)
    td, _ = tmodels.gru_model_forward(tp, cfg_t, torch.from_numpy(xs),
                                      use_delta=False)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0,
                               atol=TOL_F32)
    with pytest.raises(ValueError, match="conflict"):
        tmodels.gru_model_forward(
            tp, cfg_t, torch.from_numpy(xs), backend="dense",
            program=tprogram.compile_deltagru(tp, backend, device="cpu"))
