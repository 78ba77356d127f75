"""The reference's two block-level scan routes in the port, on the CPU.

At T > 1 the reference's blocks read an environment variable at call time:
``REPRO_RWKV_CHUNKED=1`` runs RWKV6's time-mix through the chunk-parallel
WKV (``rwkv6_chunked``), ``REPRO_RGLRU_ASSOC=1`` runs the RG-LRU block
through the log-depth associative scan (``rglru_assoc_ref``). One
``monkeypatch.setenv`` drives both packages here. At D = 64 (one head of
64) and T in {17, 64} (a padded last chunk of 16, and whole chunks), from a
zero and from a seeded state, each route is held to:

* the JAX block under the same variable: outputs and final state within
  ``TOL`` = 1e-5 of ``max(1, max|JAX|)`` (the two frameworks sum the
  chunks' matmuls and the scan's products in other orders; the largest
  measured here is 9.5e-7), and the gradient of a seeded linear readout of
  both with respect to every parameter, the input and the initial state
  within ``TOL_GRAD`` = 1e-4 of each leaf's largest JAX element (a
  gradient sums over T steps and the chunks' exponentials what the
  forward sums once; largest measured 2.0e-6);
* the port's own sequential scan (the route with the variable unset)
  within ``TOL``: the two forms are the same function in exact
  arithmetic;

and with the variable unset, or at T = 1, the route is never taken.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv

torch.set_num_threads(1)

D = 64
TOL = 1e-5
TOL_GRAD = 1e-4
RWKV_VAR, RGLRU_VAR = "REPRO_RWKV_CHUNKED", "REPRO_RGLRU_ASSOC"


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float32)


def _scaled(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _port(tree):
    return tlm.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    device="cpu")


def _leafwise(got: dict, want: dict) -> float:
    """The largest gradient error over the leaves, each scaled by the
    largest element of its JAX gradient."""
    return max(float(np.abs(_np(got[k]) - _np(want[k])).max()
                     / max(np.abs(_np(want[k])).max(), 1e-30))
               for k in want)


def _rwkv_case(t, with_state, seed=0):
    jp = jrwkv.init_rwkv_time_mix(jax.random.PRNGKey(seed), D)
    rng = np.random.default_rng(seed + 1)
    x = (rng.normal(0, 1, (2, t, D)) * 0.5).astype(np.float32)
    shape = jrwkv.init_rwkv_state(2, D).wkv.shape
    st = [np.zeros((2, D), np.float32), np.zeros((2, D), np.float32),
          np.zeros(shape, np.float32)]
    if with_state:
        st[0] = (rng.normal(0, 1, (2, D)) * 0.3).astype(np.float32)
        st[2] = (rng.normal(0, 1, shape) * 0.1).astype(np.float32)
    c_y = rng.normal(0, 1, (2, t, D)).astype(np.float32)
    c_s = rng.normal(0, 1, shape).astype(np.float32)
    return jp, x, st, c_y, c_s


def _rwkv_jax(jp, x, st, c_y, c_s):
    def loss(p, x_, wkv0):
        y, _, wkv = jrwkv.rwkv_time_mix(
            p, x_, jrwkv.RwkvState(jnp.asarray(st[0]), jnp.asarray(st[1]),
                                   wkv0))
        return jnp.sum(y * c_y) + jnp.sum(wkv * c_s), (y, wkv)

    (_, (y, wkv)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(jp, jnp.asarray(x),
                                               jnp.asarray(st[2]))
    return y, wkv, grads


def _rwkv_port(jp, x, st, c_y, c_s):
    p = {k: v.requires_grad_() for k, v in _port(jp).items()}
    x_t = torch.from_numpy(x).requires_grad_()
    wkv0 = torch.from_numpy(st[2]).requires_grad_()
    state = trwkv.RwkvState(torch.from_numpy(st[0]), torch.from_numpy(st[1]),
                            wkv0)
    y, _, wkv = trwkv.rwkv_time_mix(p, x_t, state)
    loss = (y * torch.from_numpy(c_y)).sum() + (wkv * torch.from_numpy(
        c_s)).sum()
    loss.backward()
    return y, wkv, ({k: v.grad for k, v in p.items()}, x_t.grad, wkv0.grad)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [17, 64])
def test_rwkv_chunked_route_matches_jax(t, with_state, monkeypatch):
    case = _rwkv_case(t, with_state)
    seq_y, seq_wkv, _ = _rwkv_port(*case)             # the variable unset
    monkeypatch.setenv(RWKV_VAR, "1")
    calls = []
    chunked = ops.rwkv6_chunked
    monkeypatch.setattr(ops, "rwkv6_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    jy, jwkv, jg = _rwkv_jax(*case)
    y, wkv, g = _rwkv_port(*case)
    assert calls == [1]
    assert _scaled(y, jy) <= TOL and _scaled(wkv, jwkv) <= TOL
    assert _leafwise(g[0], jg[0]) <= TOL_GRAD
    assert _leafwise({"x": g[1], "wkv0": g[2]},
                     {"x": jg[1], "wkv0": jg[2]}) <= TOL_GRAD
    # the same function as the port's sequential scan
    assert _scaled(y, seq_y) <= TOL and _scaled(wkv, seq_wkv) <= TOL


def _rglru_case(t, with_state, seed=0):
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(seed), D)
    rng = np.random.default_rng(seed + 1)
    x = (rng.normal(0, 1, (2, t, D)) * 0.5).astype(np.float32)
    st = None
    if with_state:
        st = ((rng.normal(0, 1, (2, D)) * 0.3).astype(np.float32),
              (rng.normal(0, 1, (2, 3, D)) * 0.3).astype(np.float32))
    c_y = rng.normal(0, 1, (2, t, D)).astype(np.float32)
    c_h = rng.normal(0, 1, (2, D)).astype(np.float32)
    return jp, x, st, c_y, c_h


def _rglru_jax(jp, x, st, c_y, c_h):
    def loss(p, x_, h0):
        state = None if st is None else jrglru.RglruState(
            h0, jnp.asarray(st[1]))
        y, new = jrglru.rglru_block_apply(p, x_, state)
        return jnp.sum(y * c_y) + jnp.sum(new.h * c_h), (y, new.h)

    h0 = jnp.zeros((2, D)) if st is None else jnp.asarray(st[0])
    (_, (y, h)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(jp, jnp.asarray(x), h0)
    return y, h, grads


def _rglru_port(jp, x, st, c_y, c_h):
    p = {k: v.requires_grad_() for k, v in _port(jp).items()}
    x_t = torch.from_numpy(x).requires_grad_()
    h0 = None
    state = None
    if st is not None:
        h0 = torch.from_numpy(st[0]).requires_grad_()
        state = trglru.RglruState(h0, torch.from_numpy(st[1]))
    y, new = trglru.rglru_block_apply(p, x_t, state)
    loss = (y * torch.from_numpy(c_y)).sum() + (new.h * torch.from_numpy(
        c_h)).sum()
    loss.backward()
    return y, new.h, ({k: v.grad for k, v in p.items()}, x_t.grad,
                      None if h0 is None else h0.grad)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [17, 64])
def test_rglru_assoc_route_matches_jax(t, with_state, monkeypatch):
    case = _rglru_case(t, with_state)
    seq_y, seq_h, _ = _rglru_port(*case)              # the variable unset
    monkeypatch.setenv(RGLRU_VAR, "1")
    calls = []
    assoc = trglru.rglru_assoc_ref
    monkeypatch.setattr(trglru, "rglru_assoc_ref",
                        lambda *a: calls.append(1) or assoc(*a))
    jy, jh, jg = _rglru_jax(*case)
    y, h, g = _rglru_port(*case)
    assert calls == [1]
    assert _scaled(y, jy) <= TOL and _scaled(h, jh) <= TOL
    assert _leafwise(g[0], jg[0]) <= TOL_GRAD
    assert _leafwise({"x": g[1]}, {"x": jg[1]}) <= TOL_GRAD
    if with_state:
        assert _leafwise({"h0": g[2]}, {"h0": jg[2]}) <= TOL_GRAD
    assert _scaled(y, seq_y) <= TOL and _scaled(h, seq_h) <= TOL


def test_routes_are_not_taken_unset_or_at_one_step(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the route was taken")

    jp, x, st, _, _ = _rwkv_case(17, True)
    p = _port(jp)
    state = trwkv.RwkvState(*(torch.from_numpy(a) for a in st))
    x_t = torch.from_numpy(x)
    for name in (RWKV_VAR, RGLRU_VAR):
        monkeypatch.delenv(name, raising=False)
    want = trwkv.rwkv_time_mix(p, x_t, state)
    jr, xr, str_, _, _ = _rglru_case(17, True)
    pr = _port(jr)
    st_r = trglru.RglruState(*(torch.from_numpy(a) for a in str_))
    want_r = trglru.rglru_block_apply(pr, torch.from_numpy(xr), st_r)
    monkeypatch.setattr(ops, "rwkv6_chunked", refuse)
    monkeypatch.setattr(trglru, "rglru_assoc_ref", refuse)
    for value in (None, "0"):          # unset, and set to anything but "1"
        for name in (RWKV_VAR, RGLRU_VAR):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        got = trwkv.rwkv_time_mix(p, x_t, state)
        got_r = trglru.rglru_block_apply(pr, torch.from_numpy(xr), st_r)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(got_r[0], want_r[0])
        assert all(torch.equal(a, b) for a, b in zip(got_r[1], want_r[1]))
    # one step: the sequential scan whatever the variables say
    monkeypatch.setenv(RWKV_VAR, "1")
    monkeypatch.setenv(RGLRU_VAR, "1")
    trwkv.rwkv_time_mix(p, x_t[:, :1], state)
    trglru.rglru_block_apply(pr, torch.from_numpy(xr[:, :1]), st_r)
