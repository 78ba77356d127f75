"""Latent attention (MLA) and mixture-of-experts in the PyTorch port against
the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
come across from JAX's own init through ``lm_params_from_numpy``, leaf for
leaf. Widths are small (D = 64, 4 heads, a latent of 32, 4-40 experts).

Tolerances, the error divided by ``max(1, max|reference|)``:

* ``TOL`` = 1e-5 for one module in fp32: the libraries sum the products of
  a matmul (at most 64 here) and a softmax in other orders, a few ulps;
  the aux loss is held to it too.
* The routing is held exactly in fp32: the router's probabilities of the
  two packages differ by ulps, and the tests' gaps between a token's k-th
  and (k+1)-th probability are checked to be far larger (``ROUTE_GAP``).
* ``TOL_BF16_RMS`` = 2**-3 (relative RMS) in bf16, as for the models
  (``tests/test_torch_lm.py``): the frameworks round bf16 at other places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import lm_params_from_numpy

torch.set_num_threads(1)

TOL = 1e-5
TOL_BF16_RMS = 2 ** -3
# fp32 routing must agree exactly; it could flip only where two
# probabilities lie within a few ulps (~1e-8) of each other
ROUTE_GAP = 1e-6

MLA = dict(n_heads=4, kv_lora=32, qk_nope=16, qk_rope=8, v_dim=16)
D = 64


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float32)


def _port(tree):
    return lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu")


def _t(a):
    return lm_params_from_numpy(np.asarray(a), device="cpu")


def _scaled(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _close(got, want, tol=TOL):
    err = _scaled(got, want)
    assert err <= tol, f"scaled error {err:.3e} > {tol:.1e}"


def _rel_rms(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def _cache_close(got, want, tol=TOL):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, tol)


def _x(seed, b, s, scale=1.0):
    return (np.random.default_rng(seed).normal(0, 1, (b, s, D))
            * scale).astype(np.float32)


# -- MLA -----------------------------------------------------------------------

def _mla(dtype=jnp.float32):
    jp = jmla.init_mla(jax.random.PRNGKey(7), D, dtype=dtype, **MLA)
    return jp, _port(jp)


def test_init_mla_tree_matches_jax():
    jp, _ = _mla()
    tp = tmla.init_mla(torch.Generator().manual_seed(0), D, **MLA)
    assert list(tp) == list(jp)
    for k in tp:
        want = jax.tree_util.tree_leaves(jp[k])
        got = tree_leaves(tp[k])
        assert [tuple(g.shape) for g in got] == [w.shape for w in want], k
    tc = tmla.MlaCache.zeros(3, 10, 32, 8, torch.bfloat16)
    jc = jmla.MlaCache.zeros(3, 10, 32, 8, jnp.bfloat16)
    assert [(tuple(g.shape), str(g.dtype)) for g in tc] == [
        (w.shape, "torch." + str(w.dtype)) for w in jc]


@pytest.mark.parametrize("s,q_chunk", [(7, 512), (9, 4), (12, 5)])
def test_mla_apply_matches_jax(s, q_chunk):
    """The uncompressed causal form, including a q-chunk tail."""
    jp, tp = _mla()
    x = _x(s, 2, s)
    want = jmla.mla_apply(jp, jnp.asarray(x), q_chunk=q_chunk, **MLA)
    got = tmla.mla_apply(tp, _t(x), q_chunk=q_chunk, **MLA)
    _close(got, want)


def test_mla_prefill_matches_jax():
    jp, tp = _mla()
    x = _x(1, 2, 6)
    jc = jmla.MlaCache.zeros(2, 10, 32, 8, jnp.float32)
    tc = tmla.MlaCache.zeros(2, 10, 32, 8, torch.float32)
    jy, jc = jmla.mla_prefill(jp, jnp.asarray(x), jc, **MLA)
    ty, tc2 = tmla.mla_prefill(tp, _t(x), tc, **MLA)
    assert tc2 is tc                       # written in place
    _close(ty, jy)
    _cache_close(tc, jc)
    _close(ty, jmla.mla_apply(jp, jnp.asarray(x), **MLA))


def _decode_both(jp, tp, x0, steps, index, max_len, seed=5):
    """Prefill ``x0`` in both packages, set the slots' indices to
    ``index`` (ragged), then decode ``steps`` seeded tokens. Returns the
    outputs and caches of both."""
    b = x0.shape[0]
    jc = jmla.MlaCache.zeros(b, max_len, 32, 8, jnp.float32)
    tc = tmla.MlaCache.zeros(b, max_len, 32, 8, torch.float32)
    _, jc = jmla.mla_prefill(jp, jnp.asarray(x0), jc, **MLA)
    _, tc = tmla.mla_prefill(tp, _t(x0), tc, **MLA)
    jc = jc._replace(index=jnp.asarray(index, jnp.int32))
    tc.index.copy_(torch.tensor(index, dtype=torch.int32))
    jys, tys = [], []
    for i in range(steps):
        x = _x(seed + i, b, 1)
        jy, jc = jmla.mla_decode(jp, jnp.asarray(x), jc, **MLA)
        ty, tc = tmla.mla_decode(tp, _t(x), tc, **MLA)
        jys.append(jy)
        tys.append(ty)
    return tys, jys, tc, jc


def test_mla_decode_matches_jax():
    """The absorbed form against JAX's, over ragged slots, output and
    cache after every step."""
    jp, tp = _mla()
    tys, jys, tc, jc = _decode_both(jp, tp, _x(2, 2, 6), 4, [6, 3], 12)
    for ty, jy in zip(tys, jys):
        _close(ty, jy)
    _cache_close(tc, jc)
    np.testing.assert_array_equal(tc.index.numpy(), [10, 7])


def test_mla_decode_bf16_matches_jax():
    """bf16 weights and cache. JAX's own bf16 decode does not run on the
    CPU (XLA's CPU dot has no bf16 x bf16 -> fp32 for its ``out_c`` einsum,
    ``ROADMAP.md`` R21), so the reference is JAX's fp32 decode of the same
    bf16 weights and inputs; the port's bf16 outputs and cache within
    ``TOL_BF16_RMS`` of it."""
    jp, tp = _mla(jnp.bfloat16)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    x0 = np.asarray(jnp.asarray(_x(3, 2, 6)).astype(jnp.bfloat16).astype(
        jnp.float32))
    want, cache = [], jmla.MlaCache.zeros(2, 12, 32, 8, jnp.float32)
    _, cache = jmla.mla_prefill(jp32, jnp.asarray(x0), cache, **MLA)
    tc = tmla.MlaCache.zeros(2, 12, 32, 8, torch.bfloat16)
    _, tc = tmla.mla_prefill(tp, _t(x0).bfloat16(), tc, **MLA)
    cache = cache._replace(index=jnp.asarray([6, 4], jnp.int32))
    tc.index.copy_(torch.tensor([6, 4], dtype=torch.int32))
    for i in range(3):
        x = jnp.asarray(_x(5 + i, 2, 1)).astype(jnp.bfloat16)
        jy, cache = jmla.mla_decode(jp32, x.astype(jnp.float32), cache, **MLA)
        ty, tc = tmla.mla_decode(tp, _t(np.asarray(x)), tc, **MLA)
        assert ty.dtype == torch.bfloat16
        assert _rel_rms(ty, jy) <= TOL_BF16_RMS
    assert tc.c_kv.dtype == tc.k_rope.dtype == torch.bfloat16
    assert _rel_rms(tc.c_kv, cache.c_kv) <= TOL_BF16_RMS
    assert _rel_rms(tc.k_rope, cache.k_rope) <= TOL_BF16_RMS


# the bf16 absorbed decode's scores against fp64 over the same bf16 values,
# relative to the largest: fp32 sums of 32 exact products stay within a
# few ulps (~1e-7); a term rounded to bf16 moves by up to 2**-9 of itself
TOL_SCORES_F64 = 1e-6


@pytest.mark.parametrize("rows", [None, 5])
def test_mla_decode_bf16_scores_sum_in_fp32(monkeypatch, rows):
    """R21: with a bf16 cache the decode's two score terms are fp32 sums of
    the bf16 products, added in fp32, as the reference's
    ``preferred_element_type=jnp.float32`` keeps them; neither is rounded
    to bf16. The scores ``mla_decode`` hands its softmax are held to an
    fp64 computation over the same bf16 ``q_eff``, ``q_rope`` and cache
    within ``TOL_SCORES_F64``. ``rows``: the cache rows the CPU upcasts
    at once (``SCORE_ROWS``; 5 splits the 12 rows into chunks of 5, 5 and
    2)."""
    _, tp = _mla(jnp.bfloat16)
    if rows is not None:
        monkeypatch.setattr(tmla, "SCORE_ROWS", rows, raising=False)
    cache = tmla.MlaCache.zeros(2, 12, 32, 8, torch.bfloat16)
    _, cache = tmla.mla_prefill(tp, _t(_x(3, 2, 6)).bfloat16(), cache, **MLA)
    cache.index.copy_(torch.tensor([6, 4], dtype=torch.int32))
    idx = cache.index.clone()
    x = _t(_x(8, 2, 1)).bfloat16()
    seen, softmax = [], torch.softmax

    def spy(scores, dim):
        seen.append(scores.clone())
        return softmax(scores, dim=dim)

    monkeypatch.setattr(torch, "softmax", spy)
    _, cache = tmla.mla_decode(tp, x, cache, **MLA)
    (got,) = seen
    assert got.dtype == torch.float32
    h, lora, nope, rope = (MLA[k] for k in ("n_heads", "kv_lora", "qk_nope",
                                            "qk_rope"))
    q_nope, q_rope, _, _ = tmla._project(tp, x, h, lora, nope, rope, 1e4,
                                         idx[:, None])
    w_k = tp["kv_b"].reshape(lora, h, nope + MLA["v_dim"])[..., :nope]
    q_eff = torch.einsum("bshd,lhd->bshl", q_nope, w_k).to(torch.bfloat16)
    want = (torch.einsum("bshl,btl->bhst", q_eff.double(),
                         cache.c_kv.double())
            + torch.einsum("bshr,btr->bhst", q_rope.double(),
                           cache.k_rope.double())) * (nope + rope) ** -0.5
    valid = torch.arange(12)[None] <= idx[:, None]            # [B, S]
    valid = valid[:, None, None, :].expand_as(got)
    err = (got.double() - want)[valid].abs().max() / want[valid].abs().max()
    assert err <= TOL_SCORES_F64, f"scaled error {err:.3e}"


def test_absorbed_scores_off_the_cpu_are_fp32_matmuls_of_the_cache(
        monkeypatch):
    """Off the CPU (here the meta device, as the dry-run traces it) each
    score term is one batched matmul of the bf16 operands into an fp32
    output: the cache goes in as it is stored, never upcast."""
    calls, bmm = [], torch.bmm

    def spy(a, b, **kw):
        calls.append((a.dtype, b.dtype, kw.get("out_dtype")))
        return bmm(a, b, **kw)

    monkeypatch.setattr(torch, "bmm", spy)
    bf16 = torch.bfloat16
    q, q_rope = (torch.empty((2, 1, 4, n), dtype=bf16, device="meta")
                 for n in (32, 8))
    c_kv, k_rope = (torch.empty((2, 12, n), dtype=bf16, device="meta")
                    for n in (32, 8))
    got = tmla.absorbed_scores(q, q_rope, c_kv, k_rope)
    assert got.shape == (2, 4, 1, 12) and got.dtype == torch.float32
    assert calls == [(bf16, bf16, torch.float32)] * 2


def test_absorbed_decode_matches_uncompressed_forward():
    """Prefill 5 tokens, decode 4 one by one: each decode output equals the
    uncompressed causal forward over the 9 at that position."""
    _, tp = _mla()
    x = _t(_x(4, 2, 9))
    full = tmla.mla_apply(tp, x, **MLA)
    cache = tmla.MlaCache.zeros(2, 16, 32, 8, torch.float32)
    y, cache = tmla.mla_prefill(tp, x[:, :5], cache, **MLA)
    _close(y, full[:, :5].numpy())
    for t in range(5, 9):
        y, cache = tmla.mla_decode(tp, x[:, t:t + 1], cache, **MLA)
        _close(y, full[:, t:t + 1].numpy(), 2e-5)


def test_mla_decode_past_max_len_drops_the_write():
    """At ``index >= S_max`` JAX's scatter drops the write (on the card an
    index past the cache would be a device-side fault): the port masks it,
    leaves the cache's rows, attends over every row, and still advances
    the index."""
    jp, tp = _mla()
    tys, jys, tc, jc = _decode_both(jp, tp, _x(6, 2, 4), 3, [4, 2], 4)
    for ty, jy in zip(tys, jys):
        _close(ty, jy)
    _cache_close(tc, jc)
    np.testing.assert_array_equal(tc.index.numpy(), [7, 5])
    # slot 0 wrote nothing past its prefill, slot 1 wrote rows 2 and 3
    before = tmla.MlaCache.zeros(2, 4, 32, 8, torch.float32)
    _, before = tmla.mla_prefill(tp, _t(_x(6, 2, 4)), before, **MLA)
    assert torch.equal(tc.c_kv[0], before.c_kv[0])
    assert not torch.equal(tc.c_kv[1, 2:], before.c_kv[1, 2:])


def test_mla_decode_takes_one_token():
    _, tp = _mla()
    cache = tmla.MlaCache.zeros(1, 8, 32, 8, torch.float32)
    with pytest.raises(ValueError, match="one token"):
        tmla.mla_decode(tp, torch.zeros(1, 2, D), cache, **MLA)


# -- MoE -----------------------------------------------------------------------

def _moe(n_experts=8, pad_to=8, n_shared=0, dtype=jnp.float32, seed=0,
         d_ff=32):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, d_ff, n_experts,
                       n_shared=n_shared, dtype=dtype, pad_to=pad_to)
    return jp, _port(jp)


def _gap(probs, idx, k):
    """Per token: the k-th largest probability minus the (k+1)-th."""
    p = np.sort(_np(probs), axis=-1)[:, ::-1]
    return p[:, k - 1] - p[:, k] if k < p.shape[1] else np.full(len(p), 1.0)


@pytest.mark.parametrize("e,pad_to", [(8, 8), (40, 16)])
def test_init_moe_tree_matches_jax(e, pad_to):
    """Padded experts: granite's 40 become 48; the router stays 40 wide
    and fp32 in bf16."""
    jp = jax.eval_shape(lambda: jmoe.init_moe(
        jax.random.PRNGKey(0), D, 32, e, n_shared=2, dtype=jnp.bfloat16,
        pad_to=pad_to))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), D, 32, e,
                       n_shared=2, dtype=torch.bfloat16, pad_to=pad_to)
    assert sorted(tp) == sorted(jp)
    for k in tp:
        want = jax.tree_util.tree_leaves(jp[k])
        got = tree_leaves(tp[k])
        assert [(tuple(g.shape), str(g.dtype).split(".")[-1])
                for g in got] == [(w.shape, str(w.dtype)) for w in want], k
    assert tp["experts_gate"].shape[0] == -(-e // pad_to) * pad_to
    assert tp["router"].shape == (D, e)
    assert tp["shared"]["w_up"].shape == (D, 64)


def test_route_matches_jax():
    """Top-k indices exact, renormalized gates and the Switch aux loss
    within ``TOL``; the tokens' k-th/(k+1)-th gaps are far from a tie."""
    jp, tp = _moe(40, 16)
    xt = np.random.default_rng(0).normal(0, 1, (24, D)).astype(np.float32)
    jv, ji, ja = jmoe._route(jp, jnp.asarray(xt), 8)
    tv, ti, ta = tmoe._route(tp, _t(xt), 8)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    assert _gap(probs, ji, 8).min() > ROUTE_GAP
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    _close(ta, ja)
    np.testing.assert_allclose(tv.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 1.0])
def test_moe_capacity_matches_jax_rounding(capacity_factor):
    """``int(max(top_k, round(t * top_k * cf / e)))`` with Python's round
    (half to even), at token counts that land on .5."""
    for t in range(1, 40):
        for k, e in ((2, 8), (6, 64), (8, 40), (1, 4)):
            want = int(max(k, round(t * k * capacity_factor / e)))
            assert tmoe.moe_capacity(t, k, capacity_factor, e) == want
    assert tmoe.moe_capacity(5, 1, 1.0, 2) == 2          # 2.5 -> 2
    assert tmoe.moe_capacity(7, 1, 1.0, 2) == 4          # 3.5 -> 4


MOE_CASES = {
    # name: (n_experts, pad_to, n_shared, top_k, capacity_factor, tokens)
    "no_drops": (8, 8, 0, 2, 8.0, (2, 12)),
    "padded_40_of_48": (40, 16, 0, 8, 1.25, (2, 10)),
    "shared": (4, 16, 1, 2, 4.0, (2, 7)),
    "drops_cf_0.5": (8, 8, 0, 2, 0.5, (3, 11)),
    "drops_top6": (16, 16, 2, 6, 1.0, (2, 9)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("engine", ["moe_apply", "moe_apply_onehot"])
def test_moe_matches_jax(case, engine):
    """Output and aux loss against the same engine of JAX, and the sorted
    engine against JAX's one-hot reference too. With a capacity factor
    under 1 assignments are dropped (checked from the routing), and which
    ones is decided by the stable order: a different pick moves whole
    rows of the output."""
    e, pad_to, n_shared, k, cf, (b, s) = MOE_CASES[case]
    jp, tp = _moe(e, pad_to, n_shared, seed=len(case))
    x = _x(len(case) + 1, b, s)
    kw = dict(top_k=k, capacity_factor=cf)
    jy, ja = getattr(jmoe, engine)(jp, jnp.asarray(x), **kw)
    ty, ta = getattr(tmoe, engine)(tp, _t(x), **kw)
    _close(ty, jy)
    _close(ta, ja)
    _close(ty, jmoe.moe_apply_onehot(jp, jnp.asarray(x), **kw)[0])
    _, idx, _ = tmoe._route(tp, _t(x).reshape(b * s, D), k)
    load = np.bincount(idx.numpy().ravel(), minlength=e)
    cap = tmoe.moe_capacity(b * s, k, cf, e)
    assert (load.max() > cap) == case.startswith("drops"), (load, cap)


def test_dropped_assignments_follow_the_stable_order():
    """At a capacity factor of 0.5 each expert keeps its first
    ``capacity`` assignments in token order (JAX's stable argsort; the
    one-hot reference counts them by a cumulative sum in token order). The
    tokens in two orders: the sorted engine equals JAX and the one-hot
    reference on each, so which assignments are dropped follows the
    order, as in JAX."""
    jp, tp = _moe(8, 8, seed=3)
    x = _x(9, 2, 16)
    kw = dict(top_k=2, capacity_factor=0.5)
    _, idx, _ = tmoe._route(tp, _t(x).reshape(32, D), 2)
    assert np.bincount(idx.numpy().ravel()).max() > tmoe.moe_capacity(
        32, 2, 0.5, 8)
    outs = []
    for perm in (np.arange(16), np.random.default_rng(1).permutation(16)):
        xp = x[:, perm]
        ty, _ = tmoe.moe_apply(tp, _t(xp), **kw)
        _close(ty, jmoe.moe_apply(jp, jnp.asarray(xp), **kw)[0])
        _close(ty, tmoe.moe_apply_onehot(tp, _t(xp), **kw)[0].numpy())
        outs.append(ty)
    # the drops moved with the order: some token's output changed
    inv = np.argsort(np.random.default_rng(1).permutation(16))
    assert not torch.allclose(outs[0], outs[1][:, inv], atol=1e-4)


def test_padded_experts_take_no_token():
    """The 8 padding experts of 40 -> 48 are never read: NaN weights there
    leave the output finite and unchanged."""
    _, tp = _moe(40, 16, seed=2)
    x = _t(_x(3, 2, 10))
    want, _ = tmoe.moe_apply(tp, x, top_k=8)
    for k in ("experts_gate", "experts_up", "experts_down"):
        tp[k][40:] = float("nan")
    got, _ = tmoe.moe_apply(tp, x, top_k=8)
    assert torch.equal(got, want)


def test_moe_combine_is_deterministic():
    """Two calls bitwise equal (the combine sums each token's top-k rows in
    a fixed order, no atomics), in fp32 and bf16, and the sum equals the
    one-hot reference's."""
    for dtype in (jnp.float32, jnp.bfloat16):
        _, tp = _moe(16, 16, 1, dtype=dtype, seed=4)
        x = _t(np.asarray(jnp.asarray(_x(5, 3, 8)).astype(dtype)))
        a, aux_a = tmoe.moe_apply(tp, x, top_k=6, capacity_factor=1.0)
        b, aux_b = tmoe.moe_apply(tp, x, top_k=6, capacity_factor=1.0)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
        assert a.dtype == x.dtype
        ref, _ = tmoe.moe_apply_onehot(tp, x, top_k=6, capacity_factor=1.0)
        assert _rel_rms(a, ref) <= (1e-6 if dtype == jnp.float32
                                    else 2 ** -7)


def test_moe_bf16_matches_jax():
    """bf16 experts (the router stays fp32): routing equal, outputs within
    ``TOL_BF16_RMS``."""
    jp, tp = _moe(40, 16, dtype=jnp.bfloat16, seed=6)
    x = jnp.asarray(_x(7, 2, 10)).astype(jnp.bfloat16)
    jy, ja = jmoe.moe_apply(jp, x, top_k=8)
    ty, ta = tmoe.moe_apply(tp, _t(np.asarray(x)), top_k=8)
    assert ty.dtype == torch.bfloat16
    assert _rel_rms(ty, jy) <= TOL_BF16_RMS
    _close(ta, ja)


def test_moe_apply_auto_is_the_sorted_path():
    jp, tp = _moe(8, 8)
    x = _t(_x(8, 2, 5))
    a, aux_a = tmoe.moe_apply_auto(tp, x, top_k=2)
    b, aux_b = tmoe.moe_apply(tp, x, top_k=2)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    _close(a, jmoe.moe_apply_auto(jp, jnp.asarray(x.numpy()), top_k=2)[0])
