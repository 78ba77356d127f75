"""The port's delta-linear layer (``core/delta_dense.py``) and the temporal
sparsity metrics of ``core/sparsity.py`` against the JAX package, on the
CPU.

The same numpy inputs go through both packages. ``delta_linear`` and
``delta_linear_reference`` agree within 1e-5 (the dense ``dx @ w.T`` is one
library matmul each; the running sum rounds alike), their fired fractions
and input memories exactly; at θ = 0 the reference is within 1e-4 of
``xs @ w.T``, the JAX package's own bound. The four sparsity functions
agree exactly: both packages take a mean as a sum times the reciprocal of
the count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_dense as jdd
from repro.core import sparsity as jsp
from repro_torch.core import delta_dense as tdd
from repro_torch.core import sparsity as tsp

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(seed, t=14, batch=(2,), i=6, o=9):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((o, i)).astype(np.float32)
    xs = np.cumsum(rng.normal(0, 0.4, (t, *batch, i)), 0).astype(np.float32)
    bias = rng.standard_normal((o,)).astype(np.float32)
    return w, xs, bias


@pytest.mark.parametrize("theta", [0.0, 0.2, 0.6])
@pytest.mark.parametrize("batch,i,o", [((2,), 6, 9), ((), 40, 48),
                                       ((3, 2), 13, 5)])
def test_delta_linear_steps_match_jax(theta, batch, i, o):
    w, xs, bias = _inputs(0, batch=batch, i=i, o=o)
    js = jdd.init_delta_linear_state(i, o, batch, bias=jnp.asarray(bias))
    ts = tdd.init_delta_linear_state(i, o, batch, bias=torch.from_numpy(bias),
                                     device="cpu")
    np.testing.assert_array_equal(ts.m.numpy(), np.asarray(js.m))
    for x in xs:
        jo = jdd.delta_linear(jnp.asarray(w), jnp.asarray(x), js, theta)
        to = tdd.delta_linear(torch.from_numpy(w), torch.from_numpy(x), ts,
                              theta)
        np.testing.assert_allclose(to.y.numpy(), np.asarray(jo.y), rtol=0,
                                   atol=TOL)
        assert float(to.fired_fraction) == float(jo.fired_fraction)
        np.testing.assert_array_equal(to.state.x_mem.memory.numpy(),
                                      np.asarray(jo.state.x_mem.memory))
        # carry the JAX state into both, so one step's rounding cannot flip
        # a later threshold decision
        js = jo.state
        ts = tdd.DeltaLinearState(
            tdd.DeltaState(torch.from_numpy(np.array(js.x_mem.memory))),
            torch.from_numpy(np.array(js.m)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("theta", [0.0, 0.3])
def test_delta_linear_reference_matches_jax(seed, theta):
    w, xs, _ = _inputs(seed)
    jy = np.asarray(jdd.delta_linear_reference(jnp.asarray(w),
                                               jnp.asarray(xs), theta))
    ty = tdd.delta_linear_reference(torch.from_numpy(w), torch.from_numpy(xs),
                                    theta)
    assert ty.shape == jy.shape == (14, 2, 9)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=TOL)
    if theta == 0.0:
        np.testing.assert_allclose(ty.numpy(), xs @ w.T, rtol=0, atol=1e-4)


def test_delta_linear_takes_a_sparse_matvec():
    w, xs, _ = _inputs(1)
    seen = []

    def matvec(wt, dx):
        seen.append(int((dx != 0).sum()))
        return dx @ wt.T

    st = tdd.init_delta_linear_state(6, 9, (2,), device="cpu")
    dense = tdd.init_delta_linear_state(6, 9, (2,), device="cpu")
    for x in torch.from_numpy(xs):
        out = tdd.delta_linear(torch.from_numpy(w), x, st, 0.5, matvec=matvec)
        ref = tdd.delta_linear(torch.from_numpy(w), x, dense, 0.5)
        assert torch.equal(out.y, ref.y)
        st, dense = out.state, ref.state
    assert len(seen) == 14 and 0 < sum(seen) < 14 * 12


def _masks(seed):
    rng = np.random.default_rng(seed)
    for shape in [(6,), (2, 6), (40,), (3, 40), (14, 2, 6), (9, 11),
                  (5, 13, 3), (1000,)]:
        p = rng.random()
        yield rng.random(shape) < p


@pytest.mark.parametrize("seed", range(3))
def test_fraction_zeros_and_gamma_match_jax_exactly(seed):
    for fired in _masks(seed):
        x = np.where(fired, np.float32(1.5), np.float32(0.0))
        assert float(tsp.fraction_zeros(torch.from_numpy(x))) == float(
            jsp.fraction_zeros(jnp.asarray(x)))
        assert float(tsp.gamma_from_fired(torch.from_numpy(fired))) == float(
            jsp.gamma_from_fired(jnp.asarray(fired)))


@pytest.mark.parametrize("seed", range(3))
def test_layer_and_stack_sparsity_match_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    gdx, gdh = [], []
    for layer in range(3):
        dx = np.where(rng.random((20, 2, 40)) < 0.3,
                      rng.standard_normal((20, 2, 40)), 0).astype(np.float32)
        dh = np.where(rng.random((20, 2, 48)) < 0.1,
                      rng.standard_normal((20, 2, 48)), 0).astype(np.float32)
        jg = jsp.measure_layer_sparsity(jnp.asarray(dx), jnp.asarray(dh))
        tg = tsp.measure_layer_sparsity(torch.from_numpy(dx),
                                        torch.from_numpy(dh))
        assert [float(v) for v in tg] == [float(v) for v in jg]
        gdx.append(float(jg[0]))
        gdh.append(float(jg[1]))
    j = jsp.stack_sparsity(gdx, gdh)
    t = tsp.stack_sparsity(gdx, gdh)
    assert [float(v) for v in t] == [float(v) for v in j]
    t = tsp.stack_sparsity([torch.tensor(g) for g in gdx],
                           [torch.tensor(g) for g in gdh])
    assert [float(v) for v in t] == [float(v) for v in j]
