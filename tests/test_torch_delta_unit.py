"""The engine step's two kernels' plain versions on the CPU, against the JAX
package.

* ``delta_unit_ref`` (the Delta Unit, EdgeDRNN Eq. 2 for a layer's input
  and hidden streams at once) against ``repro.core.delta.delta_encode`` on
  each stream, the input group first rounded onto the int8 / int4 layouts'
  Q8.8 grid by JAX's own ``quantize_act``: deltas and memories bitwise,
  NaN and +-inf frames included, at N = 1, 8 and 128 stream slots and
  theta 0 and 0.25 (a number and a 0-d tensor); its count rows exact
  against numpy's counts of JAX's deltas (per slot, and the tile's union).
* ``engine_epilogue_ref`` (the step's accounting and carry update), run by
  the port's CPU engine, against the JAX engine's carry after the same
  ``step`` / ``step_many`` calls: theta 0, per-layer thresholds, the
  dynamic controller, NaN and +-inf frames, a corrupted slot, N = 1, 8 and
  128, ``fused`` (fp32) and ``fused_q8`` / ``fused_q4`` (int8 / int4).
  The recurrent state is bitwise for int8 / int4 (within ``TOL_F32`` =
  1e-5 for fp32, ``test_torch_engine.py``'s bound); the carry's counts,
  flags, poison and bad-state sums and ``last_x`` bitwise, its fp32 sums
  (firing fractions and the Eq. 7 terms) within 1e-6 relative (R5: XLA
  takes its means as sum / n, the port as sum * (1 / n)), theta_h within
  1e-6 relative under the controller (its power and ratio round in each
  library's way) and bitwise without it.
* ``engine_epilogue_ref`` against the engine's accounting as it was
  written op by op on the deltas before the count rows existed: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import program as jprogram
from repro.kernels import delta_q8 as jq8
from repro.models import gru_rnn as jmodels
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro_torch.core import program as tprogram
from repro_torch.core.perf_model import (dram_traffic_bytes_per_timestep,
                                         stack_effective_macs)
from repro_torch.core.sparsity import cell_dims, recip_mean
from repro_torch.core.thresholds import ThresholdPolicy
from repro_torch.kernels import ops
from repro_torch.kernels import delta_q8 as tq8
from repro_torch.kernels.delta_unit import (FrameGuard, count_rows_ref,
                                            count_totals, delta_unit_ref)
from repro_torch.kernels.engine_epilogue import (AGGREGATES, PER_STREAM,
                                                 EpilogueConsts,
                                                 engine_epilogue_ref)
from repro_torch.models import gru_rnn as tmodels
from repro_torch.serve import engine as tengine
from repro_torch.serve import faults as tfaults

torch.set_num_threads(1)

I, H = 40, 48
TOL_F32 = 1e-5
REL = 1e-6
EXACT_CARRY = ("poison_steps", "bad_state", "agg_poison_steps",
               "agg_bad_state", "last_x")


def _streams(rng, n, width, theta):
    """``(s, memory)``: memories on the Q8.8 grid, steps exactly theta,
    exactly 0, below and above it, off the grid by half a step, NaN and
    +-inf."""
    mem = np.round(rng.normal(0, 1, (n, width)) * 256) / 256
    pick = rng.integers(0, 6, (n, width))
    step = np.choose(pick, [np.full((n, width), theta),
                            np.zeros((n, width)),
                            rng.uniform(0, 0.9, (n, width)) * theta,
                            -theta - rng.uniform(0.01, 2, (n, width)),
                            np.full((n, width), 0.5 / 256),
                            rng.normal(0, 1, (n, width))])
    s = mem + step
    special = rng.random((n, width))
    s[special < 0.02] = np.nan
    s[(special >= 0.02) & (special < 0.04)] = np.inf
    s[(special >= 0.04) & (special < 0.06)] = -np.inf
    return s.astype(np.float32), mem.astype(np.float32)


def _layouts(bits):
    rng = np.random.default_rng(7)
    w_x = (rng.normal(0, 0.2, (3 * H, I))).astype(np.float32)
    w_h = (rng.normal(0, 0.2, (3 * H, H))).astype(np.float32)
    b = np.zeros(3 * H, np.float32)
    jl = jq8.pack_delta_weights_q8(jnp.asarray(w_x), jnp.asarray(w_h),
                                   b=jnp.asarray(b), weight_bits=bits)
    tl = tq8.pack_delta_weights_q8(*map(torch.from_numpy, (w_x, w_h)),
                                   b=torch.from_numpy(b), weight_bits=bits)
    return jl, tl


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("theta", [0.0, 0.25, "tensor"])
@pytest.mark.parametrize("n", [1, 8, 128])
def test_delta_unit_ref_bitwise_against_jax(n, theta, bits):
    rng = np.random.default_rng(n)
    th = 0.25 if theta == "tensor" else theta
    t_theta = torch.tensor(th) if theta == "tensor" else th
    xs = [_streams(rng, n, I, th)]
    hs = [_streams(rng, n, H, th), _streams(rng, n, 2 * H, th)]
    grid = None
    jl = None
    if bits is not None:
        jl, tl = _layouts(bits)
        grid = tl.act_grid
    x_out, h_out, rows = delta_unit_ref(
        [tuple(map(torch.from_numpy, p)) for p in xs],
        [tuple(map(torch.from_numpy, p)) for p in hs],
        t_theta, t_theta, act_grid=grid)
    per = np.zeros((2, n), np.int64)
    union = np.zeros(2, np.int64)
    for g, (streams, outs) in enumerate(((xs, x_out), (hs, h_out))):
        for (s, mem), (d, m) in zip(streams, outs):
            js = jnp.asarray(s)
            if g == 0 and jl is not None:
                js = jl.quantize_act(js)
            je = jdelta.delta_encode(js, jdelta.DeltaState(jnp.asarray(mem)),
                                     th)
            jd, jm = np.asarray(je.delta), np.asarray(je.state.memory)
            assert d.numpy().tobytes() == jd.tobytes()
            assert m.numpy().tobytes() == jm.tobytes()
            per[g] += (jd != 0).sum(-1)
            union[g] += (jd != 0).any(0).sum()
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (2, n + 2)
    assert rows[:, -1].tolist() == [0, 1]
    totals = count_totals(rows).numpy()
    np.testing.assert_array_equal(totals[:, :n], per)
    np.testing.assert_array_equal(totals[:, n], union)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_a_zero_threshold_as_the_jitted_reference_takes_it(kind, bits):
    """A host threshold of 0 is a constant of the reference's jitted step,
    where XLA folds ``|raw| >= 0`` to true: NaN memories and NaN inputs
    fire (``StepTheta``). A threshold given as a tensor is traced there and
    keeps ``>=``, under which NaN never fires."""
    from repro_torch.core.delta import StepTheta
    rng = np.random.default_rng(11)
    n = 8
    xs = [_streams(rng, n, I, 0.0)]
    hs = [_streams(rng, n, H, 0.0)]
    for s, mem in xs + hs:
        mem[rng.random(mem.shape) < 0.1] = np.nan
    jl = grid = None
    if bits is not None:
        jl, tl = _layouts(bits)
        grid = tl.act_grid
    theta = StepTheta(0.0) if kind == "host" else torch.tensor(0.0)
    x_out, h_out, rows = delta_unit_ref(
        [tuple(map(torch.from_numpy, p)) for p in xs],
        [tuple(map(torch.from_numpy, p)) for p in hs], theta, theta,
        act_grid=grid)

    def encode(s, mem, quantize, *t):
        if quantize:
            s = jl.quantize_act(s)
        out = jdelta.delta_encode(s, jdelta.DeltaState(mem),
                                  0.0 if kind == "host" else t[0])
        return out.delta, out.state.memory

    per = np.zeros((2, n), np.int64)
    fired_nan = 0
    for g, (streams, outs) in enumerate(((xs, x_out), (hs, h_out))):
        for (s, mem), (d, m) in zip(streams, outs):
            args = (jnp.asarray(s), jnp.asarray(mem))
            if kind == "tensor":
                args += (jnp.float32(0.0),)
            fn = jax.jit(encode, static_argnums=2)
            jd, jm = map(np.asarray, fn(args[0], args[1],
                                        g == 0 and jl is not None,
                                        *args[2:]))
            np.testing.assert_array_equal(d.numpy(), jd)
            np.testing.assert_array_equal(m.numpy(), jm)
            fired_nan += int(np.isnan(jd).sum())
            per[g] += (jd != 0).sum(-1)
    # the host zero fires NaN differences; the tensor zero does not
    assert (fired_nan > 0) == (kind == "host")
    np.testing.assert_array_equal(count_totals(rows).numpy()[:, :n], per)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("n", [1, 8, 128])
def test_the_guard_in_delta_unit_ref_bitwise_against_jax(n, bits):
    """Layer 0's Delta Unit with the frame guard folded in: ``finite``, the
    guarded frame written into ``last_x`` and the deltas and memories of
    the guarded (then rounded) frame, bitwise the reference's guard
    (``jnp.all(jnp.isfinite(x))``, ``where``) and ``delta_encode``."""
    rng = np.random.default_rng(100 + n)
    s, mem = _streams(rng, n, I, 0.25)
    s[rng.random(n) < 0.5] = rng.normal(0, 1, (I,)).astype(np.float32)
    last = rng.normal(0, 1, (n, I)).astype(np.float32)
    hs = [_streams(rng, n, H, 0.25)]
    jl = grid = None
    if bits is not None:
        jl, tl = _layouts(bits)
        grid = tl.act_grid
    guard = FrameGuard(torch.from_numpy(last.copy()),
                       torch.zeros((n,), dtype=torch.bool))
    (xo,), (ho,), rows = delta_unit_ref(
        [(torch.from_numpy(s), torch.from_numpy(mem))],
        [tuple(map(torch.from_numpy, p)) for p in hs], 0.25, 0.25,
        act_grid=grid, guard=guard)
    finite = jnp.all(jnp.isfinite(jnp.asarray(s)), axis=-1)
    xg = jnp.where(finite[:, None], jnp.asarray(s), jnp.asarray(last))
    assert guard.finite.numpy().tolist() == np.asarray(finite).tolist()
    assert 0 < int(finite.sum()) < n or n == 1
    np.testing.assert_array_equal(guard.last_x.numpy(), np.asarray(xg))
    je = jdelta.delta_encode(xg if jl is None else jl.quantize_act(xg),
                             jdelta.DeltaState(jnp.asarray(mem)), 0.25)
    assert xo[0].numpy().tobytes() == np.asarray(je.delta).tobytes()
    assert xo[1].numpy().tobytes() == np.asarray(je.state.memory).tobytes()
    jd = np.asarray(je.delta)
    assert count_totals(rows).numpy()[0, :n].tolist() == \
        (jd != 0).sum(-1).tolist()


@pytest.mark.parametrize("n,width,guarded,tile", [
    (1, 768, False, 256), (2, 768, False, 128), (3, 768, False, 64),
    (8, 768, False, 32), (128, 768, False, 32), (1, 40, True, 256),
    (128, 40, True, 64), (128, 33, True, 64), (128, 32, True, 32),
    (128, 256, True, 256)])
def test_the_delta_unit_tile(n, width, guarded, tile):
    """A block: 8 warps as slot rows of ``tile`` columns, the fewest rows
    that cover the slots (up to 8), and a guarded frame's whole row."""
    from repro_torch.kernels.delta_unit import DU_THREADS, tile_columns
    assert tile_columns(n, width, guarded) == tile
    assert DU_THREADS % tile == 0 and tile % 32 == 0
    assert not guarded or width <= tile


@pytest.mark.parametrize("width,n,fits", [
    (40, 1, True), (40, 64, True), (40, 65, False), (40, 128, False),
    (16, 128, True), (16, 129, False), (256, 16, True), (256, 17, False),
    (257, 1, False)])
def test_the_guard_fits_one_turn_of_one_block(width, n, fits):
    """Layer 0's launch takes the frame guard where one block holds the
    frame's columns and every slot in one turn: its slot rows times 16
    slots in flight; the engine folds the guard there only."""
    from repro_torch.kernels.delta_unit import guard_fits
    assert guard_fits(n, width) == fits
    if width == I and n in (64, 65):
        _, _, tprog, tcfg = _setup_cell("gru", "fused_q8", 0.25)
        eng = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=n,
                                        device="cpu")
        assert eng.guard_folds == fits


def test_the_dispatch_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(0)
    xs = [tuple(map(torch.from_numpy, _streams(rng, 4, I, 0.25)))]
    hs = [tuple(map(torch.from_numpy, _streams(rng, 4, H, 0.25)))]
    ops.reset_launch_counts()
    got = ops.delta_unit(xs, hs, 0.25, 0.25)
    want = delta_unit_ref(xs, hs, 0.25, 0.25)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert all(torch.equal(x.nan_to_num(), y.nan_to_num())
                   for x, y in zip(a, b))
    assert torch.equal(got[2], want[2])
    assert sum(ops.launch_counts().values()) == 0


def test_count_rows_of_deltas_exact_at_128_slots():
    rng = np.random.default_rng(3)
    dx = torch.from_numpy(np.where(rng.random((128, 300)) < 0.01,
                                   1.0, 0.0).astype(np.float32))
    dh = torch.zeros((128, 70))
    dh[127, 69] = -1.0
    rows = count_rows_ref([dx], [dh])
    totals = count_totals(rows)
    assert totals[0, :128].tolist() == (dx != 0).sum(-1).tolist()
    assert int(totals[0, 128]) == int((dx != 0).any(0).sum())
    assert totals[1].tolist() == [0] * 127 + [1, 1]


# -- the epilogue against the accounting it replaces -------------------------

def _inline_accounting(deltas, leaves, carry, x, finite, dims, rate, bits):
    """The engine's accounting as the step wrote it op by op on the deltas
    before the count rows (the oracle of the plain version)."""
    f32 = torch.float32
    n = x.shape[0]
    poison = 1.0 - finite.to(f32)
    bad = torch.zeros((n,), dtype=f32)
    for leaf in leaves:
        bad = torch.maximum(bad, torch.any(
            ~torch.isfinite(leaf.reshape(n, -1)), dim=-1).to(f32))
    fx = recip_mean(torch.stack(
        [recip_mean((dx != 0).to(f32), dim=-1) for dx, _ in deltas]), dim=0)
    fh = recip_mean(torch.stack(
        [recip_mean((dh != 0).to(f32), dim=-1) for _, dh in deltas]), dim=0)

    def lat_of(gx, gh):
        return stack_effective_macs(dims, gx, gh) * (1.0 / rate)

    lat = lat_of(1.0 - fx, 1.0 - fh)
    wb = dram_traffic_bytes_per_timestep(dims, 1.0 - fx, 1.0 - fh,
                                         w_weight_bits=bits)
    ufx = recip_mean(torch.stack([recip_mean(torch.any(dx != 0, dim=0).to(
        f32)) for dx, _ in deltas]))
    ufh = recip_mean(torch.stack([recip_mean(torch.any(dh != 0, dim=0).to(
        f32)) for _, dh in deltas]))
    return {
        "fired_x": carry["fired_x"] + fx, "fired_h": carry["fired_h"] + fh,
        "lat_s": carry["lat_s"] + lat, "w_bytes": carry["w_bytes"] + wb,
        "agg_fired_x": carry["agg_fired_x"] + recip_mean(fx),
        "agg_fired_h": carry["agg_fired_h"] + recip_mean(fh),
        "agg_lat_s": carry["agg_lat_s"] + recip_mean(lat),
        "agg_w_bytes": carry["agg_w_bytes"] + recip_mean(wb),
        "agg_ufired_x": carry["agg_ufired_x"] + ufx,
        "agg_ufired_h": carry["agg_ufired_h"] + ufh,
        "agg_tile_lat_s": carry["agg_tile_lat_s"] + lat_of(1.0 - ufx,
                                                           1.0 - ufh),
        "agg_tile_w_bytes": carry["agg_tile_w_bytes"]
        + dram_traffic_bytes_per_timestep(dims, 1.0 - ufx, 1.0 - ufh,
                                          w_weight_bits=bits),
        "last_x": x, "poison_steps": carry["poison_steps"] + poison,
        "bad_state": carry["bad_state"] + bad,
        "agg_poison_steps": carry["agg_poison_steps"] + torch.sum(poison),
        "agg_bad_state": carry["agg_bad_state"] + torch.sum(bad),
    }, recip_mean(fh)


@pytest.mark.parametrize("n_layers", [2, 5])
@pytest.mark.parametrize("n", [1, 8, 128])
def test_epilogue_ref_is_the_inline_accounting_bitwise(n, n_layers):
    rng = np.random.default_rng(n + n_layers)
    g = torch.Generator().manual_seed(n)
    deltas, counts = [], []
    for layer in range(n_layers):
        dx = torch.from_numpy(np.where(rng.random((n, I if layer == 0 else H))
                                       < 0.2, rng.normal(0, 1, (
                                           n, I if layer == 0 else H)), 0.0)
                              .astype(np.float32))
        dh = torch.from_numpy(np.where(rng.random((n, H)) < 0.1,
                                       rng.normal(0, 1, (n, H)), 0.0)
                              .astype(np.float32))
        deltas.append((dx, dh))
        counts.append((layer, count_rows_ref([dx], [dh])))
    leaves = [torch.rand((n, H), generator=g),
              torch.rand((n, 3, 4), generator=g)[:, 1:]]
    leaves[0][0, 3] = float("nan")
    leaves[1][n - 1, 1, 2] = float("inf")
    carry = {k: torch.rand((n,), generator=g) for k in PER_STREAM}
    carry.update({k: torch.rand((), generator=g) for k in AGGREGATES})
    carry["last_x"] = torch.rand((n, I), generator=g)
    x = torch.rand((n, I), generator=g)
    finite = torch.rand((n,), generator=g) > 0.3
    dims = cell_dims("gru", I, H, n_layers)
    want, want_fh = _inline_accounting(deltas, leaves, carry, x, finite,
                                       dims, 1e9, 8)
    fh = engine_epilogue_ref(leaves, counts, [(d.shape[-1], h.shape[-1])
                                              for d, h in deltas],
                             carry, x, finite, EpilogueConsts(dims, 1e9, 8))
    for k, v in want.items():
        assert carry[k].numpy().tobytes() == v.numpy().tobytes(), k
    assert fh.numpy().tobytes() == want_fh.numpy().tobytes()


# -- the CPU engine's carry against the JAX engine's ---------------------------

def _setup(backend, theta, seed=0):
    jcfg = jmodels.GruTaskConfig(I, H, 2, 12, theta_x=theta, theta_h=theta)
    tcfg = tmodels.GruTaskConfig(I, H, 2, 12, theta_x=theta, theta_h=theta)
    jp = jmodels.init_gru_model(jax.random.PRNGKey(seed), jcfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return (jprogram.compile_deltagru(jp, backend), jcfg,
            tprogram.compile_deltagru(tp, backend, device="cpu"), tcfg)


def _frames(t, n, seed=1):
    rng = np.random.default_rng(seed)
    xs = np.cumsum(rng.normal(0, 0.3, (t, n, I)), 0).astype(np.float32)
    xs[3, 0, 5] = np.nan
    xs[4, n - 1, 0] = np.inf
    xs[7, 0, :] = -np.inf
    return xs


def _same_carry(je, te, exact_state):
    jc = jax.device_get(je._carry)
    for k, v in te._carry.items():
        got, want = v.numpy(), np.asarray(jc[k])
        if k in EXACT_CARRY or (k == "theta_h" and je.dynamic_target is None):
            assert got.tobytes() == want.tobytes(), k
        else:
            np.testing.assert_allclose(got, want, rtol=REL, atol=0, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(je.state.stack),
                    tengine._leaves(te.state.stack)):
        if exact_state:       # bitwise, a NaN of either sign equal to NaN
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=TOL_F32)


CASES = [
    # (backend, theta, engine kwargs)
    ("fused_q8", 0.25, {}),
    ("fused_q4", 0.25, {}),
    ("fused", 0.0, {}),
    ("fused_q8", 0.0, {}),
    ("fused_q4", 0.0, {}),
    ("fused_q8", 0.25, {"thresholds": ThresholdPolicy(
        0.25, 0.25, per_layer_x=(0.125,), per_layer_h=(0.0625, 0.5))}),
    ("fused_q8", 0.25, {"dynamic_target_fired": 0.2}),
]


@pytest.mark.parametrize("n", [1, 8, 128])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_engine_carry_after_steps_matches_jax(case, n):
    backend, theta, kw = CASES[case]
    jprog, jcfg, tprog, tcfg = _setup(backend, theta)
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=n, **kw)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=n, device="cpu",
                                   **kw)
    xs = _frames(12, n)
    exact = backend != "fused"
    for eng in (je, te):
        eng.open_stream()
        eng.step_many(xs[:6])
        eng.step(xs[6])
    _same_carry(je, te, exact)
    # at theta = 0 the reference's jitted step folds |raw| >= 0 to true, so
    # a NaN memory of the host-threshold group fires: the port's engine
    # step does the same (StepTheta)
    jfaults.corrupt_slot_state(je, 0)
    tfaults.corrupt_slot_state(te, 0)
    for eng in (je, te):
        eng.step_many(xs[7:])
    _same_carry(je, te, exact)
    assert float(te._carry["bad_state"][0]) == 5.0
    assert float(te._carry["agg_poison_steps"]) == 3.0


# -- the frame guard folded into layer 0's Delta Unit, against the JAX step ---

def _setup_cell(cell, backend, theta, seed=0):
    jcfg = jmodels.GruTaskConfig(I, H, 2, 12, theta_x=theta, theta_h=theta)
    tcfg = tmodels.GruTaskConfig(I, H, 2, 12, theta_x=theta, theta_h=theta)
    init = (jmodels.init_gru_model if cell == "gru"
            else jmodels.init_lstm_model)
    jp = init(jax.random.PRNGKey(seed), jcfg)
    tp = tmodels.model_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return (jprogram.compile_delta_program(jp, backend, cell=cell), jcfg,
            tprogram.compile_delta_program(tp, backend, cell=cell,
                                           device="cpu"), tcfg)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("backend", ["fused", "fused_q8", "fused_q4"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_the_folded_guard_matches_the_jax_step(cell, backend, n):
    """The port's engine runs the frame guard inside layer 0's Delta Unit
    (``guard_folds``) on the GRU / LSTM kernel backends: on frames with
    NaN and +-inf in some slots (a whole frame of -inf, single elements),
    its carry (``poison_steps``, ``last_x`` bitwise) and state equal the
    JAX engine's, whose ``_one_step`` guards the frame first."""
    jprog, jcfg, tprog, tcfg = _setup_cell(cell, backend, 0.25)
    je = jengine.DeltaStreamEngine(jprog, jcfg, n_streams=n)
    te = tengine.DeltaStreamEngine(tprog, tcfg, n_streams=n, device="cpu")
    assert te.guard_folds
    xs = _frames(12, n, seed=5)
    xs[9, n - 1, 3:7] = [np.nan, np.inf, -np.inf, np.nan]
    for eng in (je, te):
        eng.step_many(xs[:8])
        for x in xs[8:]:
            eng.step(x)
    _same_carry(je, te, backend != "fused")
    poisoned = float(te._carry["agg_poison_steps"])
    assert poisoned == float(np.sum(~np.isfinite(xs).all(-1)))
    assert np.isfinite(te._carry["last_x"].numpy()).all()


def test_the_guard_stays_in_plain_ops_where_it_does_not_fold():
    """The dense backend (its step takes no guard) and a frame wider than
    one Delta Unit tile guard the frame in plain ops before the step."""
    jprog, jcfg, tprog, tcfg = _setup_cell("gru", "dense", 0.25)
    te = tengine.DeltaStreamEngine(tprog, tcfg, device="cpu")
    assert not te.guard_folds
    wide = tmodels.GruTaskConfig(300, H, 1, 12, theta_x=0.25, theta_h=0.25)
    wide_prog = tprogram.compile_delta_program(
        tmodels.init_gru_model(0, wide, device="cpu"), "fused",
        device="cpu")
    we = tengine.DeltaStreamEngine(wide_prog, wide, device="cpu")
    assert not we.guard_folds
    x = np.ones((300,), np.float32)
    we.step(x)
    x[7] = np.nan
    we.step(x)
    assert float(we._carry["agg_poison_steps"]) == 1.0
    assert we._carry["last_x"].numpy().tolist() == [[1.0] * 300]
