"""The plain versions of the port's four LM-path kernels (``delta_spmv``,
``rwkv6_scan``, ``rglru_scan``, ``deltagru_act``) and its remaining oracles
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs its Pallas bodies in interpret mode, as ``tests/test_kernels.py``
does, and its jnp oracles. fp32 agrees within 1e-5: the libraries sum the
products of a matvec (up to 999 here) and the steps of a scan in other
orders. ``deltagru_act`` is elementwise and agrees within 1e-6.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them
against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import delta_spmv as jspmv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import deltagru as tgru
from repro_torch.core.delta import DeltaState, delta_encode
from repro_torch.kernels import delta_spmv as tspmv
from repro_torch.kernels import deltagru_cell as tcell
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trglru
from repro_torch.kernels import rwkv6_scan as trwkv

torch.set_num_threads(1)

TOL = 1e-5
TOL_ACT = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -- delta_spmv ---------------------------------------------------------------

def _spmv_inputs(o, i, b, seed, fire=0.3):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, i ** -0.5, (o, i)).astype(np.float32)
    dx = (rng.normal(0, 1, (b, i)) * (rng.uniform(size=(b, i)) < fire))
    acc = rng.normal(0, 1, (b, o))
    return w, dx.astype(np.float32), acc.astype(np.float32)


@pytest.mark.parametrize("o,i,b", [(128, 128, 1), (256, 384, 2),
                                   (300, 200, 4), (64, 513, 1),
                                   (1000, 999, 3)])
def test_delta_spmv_matches_jax(o, i, b):
    w, dx, acc = _spmv_inputs(o, i, b, seed=o * 7 + i)
    want = jops.delta_spmv(jnp.asarray(w), jnp.asarray(dx),
                           jnp.asarray(acc), interpret=True)
    _close(tspmv.delta_spmv(_t(w), _t(dx), _t(acc)), want)
    _close(tspmv.delta_spmv_ref(_t(w), _t(dx), _t(acc)),
           jref.delta_spmv_ref(jnp.asarray(w), jnp.asarray(dx),
                               jnp.asarray(acc)))
    # the packed layout, byte for byte, and the packed call with out_dim
    packed = tspmv.pack_spmv_weights(_t(w))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jspmv.pack_spmv_weights(jnp.asarray(w))))
    want_p = jops.delta_spmv(jspmv.pack_spmv_weights(jnp.asarray(w)),
                             jnp.asarray(dx), jnp.asarray(acc),
                             interpret=True, packed=True, out_dim=o)
    _close(tspmv.delta_spmv(packed, _t(dx), _t(acc), packed=True,
                            out_dim=o), want_p)


def test_delta_spmv_without_acc_and_all_zero_delta():
    w, dx, acc = _spmv_inputs(200, 300, 2, seed=3)
    _close(ops.delta_spmv(_t(w), _t(dx)),
           jops.delta_spmv(jnp.asarray(w), jnp.asarray(dx), interpret=True))
    zero = torch.zeros(2, 300)
    got = ops.delta_spmv(_t(w), zero, _t(acc))
    np.testing.assert_array_equal(got.numpy(), acc)


def test_delta_spmv_rejects_what_it_does_not_take():
    # fp32 and bf16 operands are taken in any mix (the bf16 cases below);
    # any other type is refused, as are mismatched shapes
    w, dx, acc = _spmv_inputs(128, 128, 1, seed=4)
    for other in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="fp32 and bf16 operands"):
            ops.delta_spmv(_t(w).to(other), _t(dx).to(other))
        with pytest.raises(TypeError, match="fp32 and bf16 operands"):
            ops.delta_spmv(_t(w), _t(dx), _t(acc).to(other))
    with pytest.raises(ValueError, match="padded to block_k"):
        ops.delta_spmv(_t(w)[:, :100], _t(dx)[:, :90], packed=True)
    with pytest.raises(ValueError, match="disagree on I"):
        ops.delta_spmv(_t(w), _t(dx)[:, :64])


# bf16 against the Pallas body: the products of bf16 values are exact in
# fp32 on both sides, but the fp32 sums run in other orders (at most 1e-4
# apart at these widths, |terms| <= 4 and up to 999 of them), and one bf16
# rounding of the result can then land one bf16 step (2**-8 relative, at
# most 2**-7 of |want|) apart; the fp32 output keeps the fp32 bound.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-4


@pytest.mark.parametrize("o,i,b", [(128, 128, 1), (256, 384, 2),
                                   (300, 200, 4), (64, 513, 1),
                                   (1000, 999, 3)])
def test_delta_spmv_bf16_matches_jax(o, i, b):
    w, dx, acc = _spmv_inputs(o, i, b, seed=o * 7 + i + 1)
    bf = jnp.bfloat16
    tb = torch.bfloat16
    jw, jdx, jacc = (jnp.asarray(a).astype(bf) for a in (w, dx, acc))
    tw, tdx, tacc = (_t(a).to(tb) for a in (w, dx, acc))
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw, np.float32))
    for t_acc, j_acc in ((tacc, jacc), (None, None), (tacc.float(),
                                                     jacc.astype(np.float32))):
        want = jops.delta_spmv(jw, jdx, j_acc, interpret=True)
        got = tspmv.delta_spmv(tw, tdx, t_acc)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
    # the packed layout and a mixed call (fp32 deltas, bf16 weights)
    packed = tspmv.pack_spmv_weights(tw)
    want = jops.delta_spmv(jspmv.pack_spmv_weights(jw), jdx, jacc,
                           interpret=True, packed=True, out_dim=o)
    got = tspmv.delta_spmv(packed, tdx, tacc, packed=True, out_dim=o)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    want = jops.delta_spmv(jw, jnp.asarray(dx), jnp.asarray(acc),
                           interpret=True)
    got = tspmv.delta_spmv(tw, _t(dx), _t(acc))
    assert got.dtype == torch.float32
    _close(got, want, tol=BF16_ATOL)


def test_hbm_bytes_model_and_fire_mask_match_jax():
    rng = np.random.default_rng(5)
    dx = np.zeros((3, 600), np.float32)
    dx[0, 5] = 1.0
    dx[2, 400:410] = rng.normal(size=10)
    for shape in ((256, 600), (64, 600)):
        assert int(tspmv.delta_spmv_hbm_bytes(shape, _t(dx))) == int(
            jops.delta_spmv_hbm_bytes(shape, jnp.asarray(dx)))
    np.testing.assert_array_equal(
        tref.block_fire_mask(_t(dx)).numpy(),
        np.asarray(jref.block_fire_mask(jnp.asarray(dx))))


# -- rwkv6_scan ---------------------------------------------------------------

def _wkv_inputs(b, h, t, d, seed, s0=True):
    rng = np.random.default_rng(seed)
    mk = lambda: (rng.normal(0, 0.1, (b, h, t, d))).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = (1 / (1 + np.exp(-rng.normal(size=(b, h, t, d))))).astype(np.float32)
    u = rng.normal(0, 0.1, (h, d)).astype(np.float32)
    s = (rng.normal(0, 0.1, (b, h, d, d)).astype(np.float32) if s0
         else None)
    return r, k, v, w, u, s


@pytest.mark.parametrize("b,h,t", [(1, 1, 16), (2, 3, 37), (1, 2, 128),
                                   (2, 2, 1)])
def test_rwkv6_scan_matches_jax(b, h, t):
    ins = _wkv_inputs(b, h, t, 64, seed=t)
    jins = [None if a is None else jnp.asarray(a) for a in ins]
    tins = [None if a is None else _t(a) for a in ins]
    y1, s1 = jops.rwkv6_scan(*jins, chunk=16, interpret=True)
    y2, s2 = jref.rwkv6_scan_batched_ref(*jins)
    y, s = trwkv.rwkv6_scan(*tins)
    for want_y, want_s in ((y1, s1), (y2, s2)):
        _close(y, want_y)
        _close(s, want_s)


def test_rwkv6_scan_single_head_and_zero_state():
    r, k, v, w, u, _ = _wkv_inputs(1, 1, 20, 64, seed=8, s0=False)
    y, s = trwkv.rwkv6_scan_ref(_t(r[0, 0]), _t(k[0, 0]), _t(v[0, 0]),
                                _t(w[0, 0]), _t(u[0]))
    jy, js = jref.rwkv6_scan_ref(*(jnp.asarray(a[0, 0]) for a in
                                   (r, k, v, w)), jnp.asarray(u[0]))
    _close(y, jy)
    _close(s, js)


def test_rwkv6_chunked_matches_jax_and_the_scan():
    b, h, t = 2, 2, 37
    rng = np.random.default_rng(t)
    mk = lambda: rng.normal(0, 0.2, (b, h, t, 64)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = np.exp(-np.exp(rng.normal(size=(b, h, t, 64)) - 2)).astype(
        np.float32)
    u = rng.normal(0, 0.1, (h, 64)).astype(np.float32)
    s0 = rng.normal(0, 0.1, (b, h, 64, 64)).astype(np.float32)
    y, s = ops.rwkv6_chunked(*map(_t, (r, k, v, w, u, s0)), chunk=8)
    jy, js = jops.rwkv6_chunked(*map(jnp.asarray, (r, k, v, w, u, s0)),
                                chunk=8)
    _close(y, jy)
    _close(s, js)
    ys, ss = trwkv.rwkv6_scan_batched_ref(*map(_t, (r, k, v, w, u, s0)))
    _close(y, ys)
    _close(s, ss)


def test_rwkv6_chunked_differentiable():
    r, k, v, w, u, _ = _wkv_inputs(1, 1, 32, 64, seed=0, s0=False)
    rt = _t(r).requires_grad_(True)
    y, _ = ops.rwkv6_chunked(rt, _t(k), _t(v), _t(w), torch.zeros(1, 64))
    torch.sum(y ** 2).backward()
    assert torch.isfinite(rt.grad).all()



# -- rwkv6_scan with bf16 r, k, v (row 9b) ------------------------------------
# The bf16 RWKV6 models hand the scan bf16 r, k, v beside fp32 w, u and
# state. The plain version computes under PyTorch's type promotion, which is
# JAX's: the outer product k^T v is a bf16 product, rounded to bf16, and all
# it meets afterwards is fp32. Eagerly, op by op, JAX rounds it too, and the
# two agree within the fp32 tolerance (their sums over keys run in other
# orders). JAX's compiled oracle (lax.scan under jit) keeps the product in
# fp32 instead (XLA's excess precision, R19 in ROADMAP.md), so it is held
# within what that one rounding can move: k v rounds by at most 2**-9 of
# itself, and y and the state sum such terms over keys and steps, each
# within 2**-9 of its own magnitude, 2**-8 keeping a factor of two.
TOL_BF16_ROUNDING = 2 ** -8


def _bf16(a):
    import ml_dtypes
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _wkv_bf16_inputs(b, h, t, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (_bf16(rng.normal(0, 1, (b, h, t, 64))) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-3, 1.5, (b, h, t, 64)))).astype(
        np.float32)
    u = rng.normal(0, 0.1, (h, 64)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, h, 64, 64)).astype(np.float32)
    return r, k, v, w, u, s0


def _torch_bf16(a):
    from repro_torch.models.lm import lm_params_from_numpy
    return lm_params_from_numpy(a, device="cpu")


def _eager_jax_wkv(r, k, v, w, u, s):
    """The WKV recurrence in JAX op by op (no jit, no scan), so each bf16
    product is rounded as its types say."""
    ys = []
    for i in range(r.shape[2]):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        y = jnp.matmul(r[:, :, i, None, :], s + u[:, :, None] * kv)[..., 0, :]
        s = w[:, :, i, :, None] * s + kv
        ys.append(y)
    return jnp.stack(ys, axis=2), s


def _scaled(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("b,h,t", [(1, 1, 1), (2, 3, 9), (1, 2, 40),
                                   (4, 2, 128)])
def test_rwkv6_scan_bf16_plain_version_matches_jax(b, h, t):
    ins = _wkv_bf16_inputs(b, h, t, seed=b * 100 + t)
    y, s = trwkv.rwkv6_scan(*(_torch_bf16(a) for a in ins))
    assert y.dtype == s.dtype == torch.float32
    ey, es = _eager_jax_wkv(*map(jnp.asarray, ins))
    assert _scaled(y, ey) <= TOL and _scaled(s, es) <= TOL
    jy, js = jref.rwkv6_scan_batched_ref(*map(jnp.asarray, ins))
    assert jy.dtype == js.dtype == jnp.float32
    assert _scaled(y, jy) <= TOL_BF16_ROUNDING
    assert _scaled(s, js) <= TOL_BF16_ROUNDING


def test_bf16_promotion_equals_jax():
    """bf16 x bf16 -> bf16 (one rounding to nearest even, bitwise JAX's),
    bf16 with fp32 -> fp32, in elementwise ops: the rules the bf16 plain
    version relies on."""
    for a, b in ((torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32),
                 (torch.float32, torch.bfloat16)):
        ja, jb = (jnp.dtype(str(x).split(".")[1]) for x in (a, b))
        assert str(torch.promote_types(a, b)).split(".")[1] == str(
            jnp.promote_types(ja, jb))
    rng = np.random.default_rng(5)
    k, v = _bf16(rng.normal(0, 1, 4096)), _bf16(rng.normal(0, 3, 4096))
    want = np.asarray(jnp.asarray(k) * jnp.asarray(v))
    got = _torch_bf16(k) * _torch_bf16(v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    u = rng.normal(0, 1, 4096).astype(np.float32)
    mixed = torch.from_numpy(u) * got
    assert mixed.dtype == torch.float32
    np.testing.assert_array_equal(mixed.numpy(), np.asarray(
        jnp.asarray(u) * jnp.asarray(want)))

# -- rglru_scan ---------------------------------------------------------------

def _lru_inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.normal(size=(b, t, d))))).astype(np.float32)
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    return x, a, h0


@pytest.mark.parametrize("b,t,d", [(1, 16, 128), (2, 50, 200), (3, 33, 64),
                                   (2, 1, 96)])
def test_rglru_scan_matches_jax(b, t, d):
    x, a, h0 = _lru_inputs(b, t, d, seed=d)
    y, h = trglru.rglru_scan(_t(x), _t(a), _t(h0))
    for want_y, want_h in (
            jops.rglru_scan(*map(jnp.asarray, (x, a, h0)), chunk=16,
                            interpret=True),
            jref.rglru_scan_batched_ref(*map(jnp.asarray, (x, a, h0)))):
        _close(y, want_y)
        _close(h, want_h)
    y0, h0_ = trglru.rglru_scan(_t(x), _t(a))
    jy0, jh0 = jref.rglru_scan_batched_ref(jnp.asarray(x), jnp.asarray(a))
    _close(y0, jy0)
    _close(h0_, jh0)


def test_rglru_single_sequence_and_frozen_state():
    x, a, h0 = _lru_inputs(1, 12, 40, seed=2)
    y, h = trglru.rglru_scan_ref(_t(x[0]), _t(a[0]), _t(h0[0]))
    jy, jh = jref.rglru_scan_ref(*(jnp.asarray(z[0]) for z in (x, a, h0)))
    _close(y, jy)
    _close(h, jh)
    # a = 1 freezes the state at h0
    _, h_frozen = trglru.rglru_scan(torch.ones(1, 8, 16), torch.ones(1, 8, 16),
                                    torch.full((1, 16), 3.0))
    np.testing.assert_array_equal(h_frozen.numpy(), np.full((1, 16), 3.0))


@pytest.mark.parametrize("t", [16, 100, 257])
def test_rglru_assoc_matches_jax_and_the_scan(t):
    x, a, h0 = _lru_inputs(3, t, 32, seed=t)
    y, h = tref.rglru_assoc_ref(_t(x), _t(a), _t(h0))
    jy, jh = jref.rglru_assoc_ref(*map(jnp.asarray, (x, a, h0)))
    _close(y, jy)
    _close(h, jh)
    ys, hs = trglru.rglru_scan_batched_ref(_t(x), _t(a), _t(h0))
    _close(y, ys)
    _close(h, hs)


# -- deltagru_act and the composed GRU step -----------------------------------

@pytest.mark.parametrize("b,h", [(1, 128), (2, 200), (4, 768), (1, 5),
                                 (3, 130)])
def test_deltagru_act_matches_jax(b, h):
    rng = np.random.default_rng(b * 31 + h)
    m, zx, zh, hp = (rng.normal(size=s).astype(np.float32)
                     for s in ((b, 4 * h), (b, 3 * h), (b, 3 * h), (b, h)))
    m1, h1 = tcell.deltagru_act(*map(_t, (m, zx, zh, hp)))
    for want_m, want_h in (
            jops.deltagru_act(*map(jnp.asarray, (m, zx, zh, hp)),
                              interpret=True),
            jref.deltagru_act_ref(*map(jnp.asarray, (m, zx, zh, hp)))):
        _close(m1, want_m, TOL_ACT)
        _close(h1, want_h, TOL_ACT)


def test_deltagru_cell_fused_equals_the_dense_step_and_jax():
    """``ops.deltagru_cell_fused`` (two unpacked spmvs at I = 40, whose
    ragged edge the kernel masks, and the activation) is the dense GRU
    step, in the port and against the JAX package's composition."""
    rng = np.random.default_rng(0)
    i_dim, h_dim = 40, 96
    s = (6.0 / (i_dim + 3 * h_dim)) ** 0.5
    w_x = rng.uniform(-s, s, (3 * h_dim, i_dim)).astype(np.float32)
    w_h = rng.uniform(-s, s, (3 * h_dim, h_dim)).astype(np.float32)
    b = rng.normal(0, 0.3, 3 * h_dim).astype(np.float32)
    p = tgru.GruLayerParams(_t(w_x), _t(w_h), _t(b))
    st = tgru.init_deltagru_state(p, (2,))
    st = st._replace(h=_t(rng.uniform(-1, 1, (2, h_dim))),
                     h_mem=DeltaState(_t(rng.uniform(-1, 1, (2, h_dim)))))
    x = _t(rng.normal(size=(2, i_dim)))
    want = tgru.deltagru_step(p, st, x, 0.05, 0.05, backend="dense")
    dx = delta_encode(x, st.x_mem, 0.05).delta
    dh = delta_encode(st.h, st.h_mem, 0.05).delta
    ops.reset_launch_counts()
    m_new, h_new = ops.deltagru_cell_fused(p.w_x, p.w_h, st.m, st.h, dx, dh)
    assert sum(ops.launch_counts().values()) == 0      # CPU: plain versions
    _close(h_new, want.h)
    _close(m_new, want.state.m)
    jm, jh = jops.deltagru_cell_fused(
        *map(jnp.asarray, (w_x, w_h, st.m.numpy(), st.h.numpy(),
                           dx.numpy(), dh.numpy())), interpret=True)
    _close(m_new, jm)
    _close(h_new, jh)
