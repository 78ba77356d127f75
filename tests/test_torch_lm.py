"""The LM zoo's modules and models in the PyTorch port against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
come across from JAX's own init through ``lm_params_from_numpy``, leaf for
leaf. The configs are ``cfg.reduced()`` (2-3 layers, D = 64, vocab 128) of
the six architectures whose blocks are ported.

Tolerances, all of the error divided by ``max(1, max|reference|)``:

* ``TOL`` = 1e-5 for one module in fp32: the libraries sum the products of
  a matmul (at most 128 here) and a softmax in other orders, a few ulps.
* ``TOL_LM`` = 2e-5 for a whole model in fp32: the error of each layer
  passes to the next through the residual stream, group norm (RWKV6),
  which divides by a head's standard deviation, and a vocab projection;
  the largest measured here is 3.7e-6 (the RG-LRU caches after four
  decode steps), and 2e-5 keeps a factor of five.
* bf16 (the configs' own dtype): the two frameworks round at other places
  (XLA keeps fp32 inside fused ops, R19), so no bound per element holds;
  over six seeds the logits of either package lie 0.8-4.8 % (relative
  RMS) from the fp32 function of the same bf16 weights and 0.8-4.3 % from
  each other (at most 3.5 % in this file's run). ``TOL_BF16_RMS`` = 2**-3
  keeps a factor of three. Norms alone are one rounding from equal: within
  one bf16 step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = 1e-5
TOL_LM = 2e-5
TOL_BF16_RMS = 2 ** -3

PORTED = ("smollm-360m", "llama3.2-1b", "olmo-1b", "qwen2.5-32b",
          "recurrentgemma-9b", "rwkv6-1.6b")
UNPORTED = {"deepseek-v2-lite-16b": "5b", "granite-moe-3b-a800m": "5b",
            "llama-3.2-vision-11b": "5c", "seamless-m4t-large-v2": "5c"}


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _t(a):
    return tlm.lm_params_from_numpy(np.asarray(a), device="cpu")


def _scaled(got, want) -> float:
    got, want = _np(got.float() if isinstance(got, torch.Tensor) else got), \
        _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _close(got, want, tol=TOL):
    err = _scaled(got, want)
    assert err <= tol, f"scaled error {err:.3e} > {tol:.1e}"


def _rel_rms(got, want) -> float:
    got = _np(got.float() if isinstance(got, torch.Tensor) else got)
    want = _np(want)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return tlm.lm_params_from_numpy(_np_tree(tree), device="cpu")


def _cfgs(arch, **kw):
    return (jreg.get_config(arch).reduced(**kw),
            treg.get_config(arch).reduced(**kw))


def _trees_close(got, want, tol):
    got_l, want_l = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, tol)


# -- common: norms, RoPE, activations ------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(kind, dtype):
    rng = np.random.default_rng(len(kind))
    x = (rng.normal(0, 3, (2, 5, 96)) + 1.5).astype(np.float32)
    jparams = jcommon.init_norm(kind, 96, jnp.float32)
    jparams = {k: v * rng.uniform(0.5, 2, 96).astype(np.float32)
               for k, v in jparams.items()}
    jx = jnp.asarray(x).astype(dtype)
    want = jcommon.apply_norm(kind, jparams, jx)
    got = tcommon.apply_norm(kind, _port(jparams), _t(np.asarray(jx)))
    assert str(got.dtype).endswith(dtype)
    if dtype == "float32":
        _close(got, want)
    else:     # one rounding to bf16 of fp32 results equal within an ulp
        diff = np.abs(_np(got.float()) - _np(want))
        assert (diff <= 2 ** -8 * np.abs(_np(want)) + 1e-30).all()
        assert (diff == 0).mean() > 0.99


def test_norm_init_and_unknown_kind():
    for kind in ("rmsnorm", "layernorm", "layernorm_np"):
        want = jcommon.init_norm(kind, 8, jnp.bfloat16)
        got = tcommon.init_norm(kind, 8, torch.bfloat16)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(got[k].float()), _np(want[k]))
    with pytest.raises(ValueError, match="unknown norm"):
        tcommon.init_norm("batchnorm", 8)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(int(theta) % 97)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 7)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(tcommon.apply_rope(_t(x), _t(pos), theta), want, 1e-4)
    _close(tcommon.rope_freqs(16, theta), jcommon.rope_freqs(16, theta))
    # split halves, not interleaved pairs: position 0 is the identity and
    # the rotation pairs channel i with channel i + D/2
    got0 = tcommon.apply_rope(_t(x), torch.zeros(2, 7, dtype=torch.int32))
    np.testing.assert_array_equal(got0.numpy(), x)


@pytest.mark.parametrize("name", sorted(jcommon.ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(tcommon.ACTIVATIONS[name](_t(x)),
           jcommon.ACTIVATIONS[name](jnp.asarray(x)), 1e-6)
    assert sorted(tcommon.ACTIVATIONS) == sorted(jcommon.ACTIVATIONS)


# -- attention -----------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 3), (False, 5)])
def test_mask_bias_matches_jax(causal, window):
    q, k = np.arange(4, 11), np.arange(12)
    want = jattn._mask_bias(jnp.asarray(q), jnp.asarray(k), causal, window)
    got = tattn._mask_bias(_t(q), _t(k), causal, window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hq,hkv,dtype", [(4, 4, "float32"),
                                          (6, 2, "float32"),
                                          (4, 1, "float32"),
                                          (4, 2, "bfloat16")])
def test_sdpa_matches_jax(hq, hkv, dtype):
    rng = np.random.default_rng(hq * 10 + hkv)
    q = jnp.asarray(rng.normal(0, 1, (2, 5, hq, 16))).astype(dtype)
    k = jnp.asarray(rng.normal(0, 1, (2, 9, hkv, 16))).astype(dtype)
    v = jnp.asarray(rng.normal(0, 1, (2, 9, hkv, 16))).astype(dtype)
    bias = jattn._mask_bias(jnp.arange(4, 9), jnp.arange(9), True, None)
    for b in (None, bias[None], jnp.broadcast_to(bias, (2, 5, 9))):
        want = jattn.sdpa(q, k, v, b)
        got = tattn.sdpa(*(_t(np.asarray(a)) for a in (q, k, v)),
                         None if b is None else _t(np.asarray(b)))
        assert str(got.dtype).endswith(dtype)
        _close(got, want, TOL if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("sq,q_chunk,window,offset", [
    (12, 512, None, 0), (12, 5, None, 0), (13, 4, 6, 0), (7, 3, None, 5),
    (20, 8, 4, 2)])
def test_chunked_attention_matches_jax(sq, q_chunk, window, offset):
    """Including a q-chunk tail (sq % q_chunk != 0) and a window."""
    rng = np.random.default_rng(sq + q_chunk)
    q = rng.normal(0, 1, (2, sq, 4, 8)).astype(np.float32)
    k = rng.normal(0, 1, (2, sq + offset, 2, 8)).astype(np.float32)
    v = rng.normal(0, 1, (2, sq + offset, 2, 8)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=q_chunk, q_offset=offset)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _close(tattn.chunked_attention(*map(_t, (q, k, v)), **kw), want)


def _kv(b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, 2, 8)).astype(np.float32),
            rng.normal(0, 1, (b, s, 2, 8)).astype(np.float32))


@pytest.mark.parametrize("s,w", [(3, 8), (8, 8), (13, 8)])
def test_ring_writes_match_jax(s, w):
    """``cache_write_prefill`` keeps the last ``W`` positions; decode writes
    each slot at its own (ragged) position, wrapping the ring."""
    jc = jattn.KVCache.zeros(2, w, 2, 8, jnp.float32)
    tc = tattn.KVCache.zeros(2, w, 2, 8, torch.float32)
    k, v = _kv(2, s, s)
    jc = jattn.cache_write_prefill(jc, jnp.asarray(k), jnp.asarray(v))
    tc = tattn.cache_write_prefill(tc, _t(k), _t(v))
    _trees_close(tc, jc, 0.0)
    jc = jc._replace(index=jnp.asarray([s, max(1, s - 2)], jnp.int32))
    tc.index.copy_(_t(np.asarray(jc.index)))
    for step in range(w + 3):
        k, v = _kv(2, 1, 100 + step)
        jc = jattn.cache_write_decode(jc, jnp.asarray(k), jnp.asarray(v))
        tc2 = tattn.cache_write_decode(tc, _t(k), _t(v))
        assert tc2 is tc               # written in place
        _trees_close(tc, jc, 0.0)
    assert tc.capacity == w


def _attn_setup(window=8, d_model=32, heads=2, kv=1):
    jp = jattn.init_attention(jax.random.PRNGKey(0), d_model, heads, kv,
                              d_model // heads)
    kw = dict(n_heads=heads, n_kv_heads=kv, head_dim=d_model // heads,
              window=window)
    return jp, _port(jp), kw, d_model


class TestRingCacheWraparound:
    """The three tests of ``tests/test_cache_and_compression.py``, on the
    port, each also held to the JAX package's run."""

    def test_decode_past_window_matches_full_sequence(self):
        window = 8
        jp, tp, kw, d = _attn_setup(window)
        b, s_total = 2, 24                    # 3x the window: wraps twice
        xs = (np.random.default_rng(1).normal(0, 1, (b, s_total, d))
              * 0.5).astype(np.float32)
        want = tattn.attention_apply(tp, _t(xs), causal=True, **kw)
        _close(want, jattn.attention_apply(jp, jnp.asarray(xs), causal=True,
                                           **kw))
        cache = tattn.KVCache.zeros(b, window, kw["n_kv_heads"],
                                    kw["head_dim"], torch.float32)
        out_p, cache = tattn.attention_prefill(tp, _t(xs[:, :4]), cache,
                                               **kw)
        outs = [out_p]
        for t in range(4, s_total):
            y, cache = tattn.attention_decode(tp, _t(xs[:, t:t + 1]), cache,
                                              **kw)
            outs.append(y)
        _close(torch.cat(outs, dim=1), want.numpy(), 2e-4)

    def test_ring_slots_hold_window_positions(self):
        window = 4
        _, tp, kw, d = _attn_setup(window)
        cache = tattn.KVCache.zeros(1, window, 1, d // 2, torch.float32)
        xs = _t(np.random.default_rng(2).normal(0, 1, (1, 11, d)).astype(
            np.float32))
        _, cache = tattn.attention_prefill(tp, xs[:, :3], cache, **kw)
        for t in range(3, 11):
            _, cache = tattn.attention_decode(tp, xs[:, t:t + 1], cache,
                                              **kw)
        np.testing.assert_array_equal(np.sort(cache.positions[0].numpy()),
                                      [7, 8, 9, 10])

    def test_ragged_slots_decode_independently(self):
        jp, tp, kw, d = _attn_setup()
        kw["window"] = None
        rng = np.random.default_rng(3)
        xa = (rng.normal(0, 1, (1, 6, d)) * 0.5).astype(np.float32)
        xb = (rng.normal(0, 1, (1, 3, d)) * 0.5).astype(np.float32)

        def run_single(x, steps):
            cache = tattn.KVCache.zeros(1, 16, kw["n_kv_heads"],
                                        kw["head_dim"], torch.float32)
            _, cache = tattn.attention_prefill(tp, _t(x), cache, **kw)
            ys = []
            for _ in range(steps):
                y, cache = tattn.attention_decode(tp, _t(x[:, -1:]), cache,
                                                  **kw)
                ys.append(y)
            return torch.cat(ys, 1)

        ya, yb = run_single(xa, 3), run_single(xb, 3)
        cache = tattn.KVCache.zeros(2, 16, kw["n_kv_heads"], kw["head_dim"],
                                    torch.float32)
        xpad = np.concatenate(
            [xa, np.concatenate([xb, np.zeros((1, 3, d), np.float32)], 1)])
        _, cache = tattn.attention_prefill(tp, _t(xpad), cache, **kw)
        cache.index.copy_(torch.tensor([6, 3], dtype=torch.int32))
        x_steps = _t(np.concatenate([xa[:, -1:], xb[:, -1:]], 0))
        jcache = jattn.KVCache.zeros(2, 16, kw["n_kv_heads"], kw["head_dim"],
                                     jnp.float32)
        _, jcache = jattn.attention_prefill(jp, jnp.asarray(xpad), jcache,
                                            **kw)
        jcache = jcache._replace(index=jnp.array([6, 3], jnp.int32))
        ys, jys = [], []
        for _ in range(3):
            y, cache = tattn.attention_decode(tp, x_steps, cache, **kw)
            jy, jcache = jattn.attention_decode(jp, jnp.asarray(x_steps),
                                                jcache, **kw)
            ys.append(y)
            jys.append(jy)
        got = torch.cat(ys, 1)
        _close(got[0], ya[0].numpy(), 2e-4)
        _close(got[1], yb[0].numpy(), 2e-4)
        _close(got, jnp.concatenate(jys, 1))
        _trees_close(cache, jcache, TOL)


def test_attention_decode_takes_one_token():
    _, tp, kw, d = _attn_setup()
    cache = tattn.KVCache.zeros(1, 8, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="one token"):
        tattn.attention_decode(tp, torch.zeros(1, 2, d), cache, **kw)


# -- ffn -----------------------------------------------------------------------

@pytest.mark.parametrize("gated,activation", [(True, "silu"),
                                              (True, "gelu_tanh"),
                                              (False, "relu"),
                                              (False, "relu_sq")])
def test_ffn_matches_jax(gated, activation):
    jp = jffn.init_ffn(jax.random.PRNGKey(3), 32, 96, gated=gated)
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 32)).astype(np.float32)
    want = jffn.ffn_apply(jp, jnp.asarray(x), activation=activation)
    _close(tffn.ffn_apply(_port(jp), _t(x), activation=activation), want)
    tp = tffn.init_ffn(torch.Generator().manual_seed(0), 32, 96, gated=gated)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}


# -- blocks --------------------------------------------------------------------

BLOCK_ARCH = {"attn": "llama3.2-1b", "local_attn": "recurrentgemma-9b",
              "rglru": "recurrentgemma-9b", "rwkv": "rwkv6-1.6b"}


@pytest.mark.parametrize("kind", sorted(BLOCK_ARCH))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_block_matches_jax(kind, mode):
    jcfg, tcfg = _cfgs(BLOCK_ARCH[kind], attn_window=4)
    jp = jblocks.init_block(kind, jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = _port(jp)
    rng = np.random.default_rng(6)
    s = 1 if mode == "decode" else 7
    x = rng.normal(0, 1, (2, s, jcfg.d_model)).astype(np.float32)
    jc = tc = None
    if mode != "train":
        jc = jblocks.init_block_cache(kind, jcfg, 2, 8, jnp.float32)
        if mode == "decode":     # a cache in use: prefill 5 tokens first
            x0 = rng.normal(0, 1, (2, 5, jcfg.d_model)).astype(np.float32)
            _, jc, _ = jblocks.apply_block(kind, jp, jnp.asarray(x0), jcfg,
                                           "prefill", jc)
        tc = _port(jc)
    jy, jnew, jaux = jblocks.apply_block(kind, jp, jnp.asarray(x), jcfg, mode,
                                         jc)
    ty, tnew, taux = tblocks.apply_block(kind, tp, _t(x), tcfg, mode, tc)
    _close(ty, jy)
    assert float(taux) == float(jaux) == 0.0
    if mode == "train":
        assert tnew is None and jnew is None
    else:
        _trees_close(tnew, jnew, TOL)


def test_block_init_and_cache_shapes_match_jax():
    for kind, arch in BLOCK_ARCH.items():
        jcfg, tcfg = _cfgs(arch)
        jp = jblocks.init_block(kind, jax.random.PRNGKey(0), jcfg,
                                jnp.float32)
        tp = tblocks.init_block(kind, torch.Generator().manual_seed(0), tcfg,
                                torch.float32)
        assert _shapes(tp) == _shapes(jp), kind
        jc = jblocks.init_block_cache(kind, jcfg, 3, 40, jnp.bfloat16)
        tc = tblocks.init_block_cache(kind, tcfg, 3, 40, torch.bfloat16)
        assert type(tc).__name__ == type(jc).__name__
        _trees_close(tc, jc, 0.0)
        assert _shapes(tc) == _shapes(jc), kind


def _shapes(tree):
    """Leaf paths with shape and dtype, of either package's tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (k,))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), path + (f,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = (tuple(node.shape), str(node.dtype).split(".")[-1])
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", sorted(jreg.ARCH_IDS))
def test_make_schedule_matches_jax(arch):
    assert (tblocks.make_schedule(treg.get_config(arch))
            == jblocks.make_schedule(jreg.get_config(arch)))


class TestSeqVersusDecode:
    """``tests/test_scan_decode_parity.py``'s block tests on the port:
    the full-sequence block against its one-token decode, carried step by
    step from a nonzero state."""

    def test_rglru_apply_matches_decode_loop(self):
        jp = jrglru.init_rglru_block(jax.random.PRNGKey(0), 64)
        p = _port(jp)
        rng = np.random.default_rng(0)
        x = _t((rng.normal(0, 1, (2, 12, 64)) * 0.5).astype(np.float32))
        st0 = trglru.RglruState(
            h=_t((rng.normal(0, 1, (2, 64)) * 0.3).astype(np.float32)),
            conv=_t((rng.normal(0, 1, (2, 3, 64)) * 0.3).astype(np.float32)))
        ys_seq, st_seq = trglru.rglru_block_apply(p, x, st0)
        st, ys = st0, []
        for t in range(x.shape[1]):
            y, st = trglru.rglru_block_decode(p, x[:, t:t + 1], st)
            ys.append(y[:, 0])
        _close(ys_seq, torch.stack(ys, 1).numpy(), 1e-6)
        _close(st_seq.h, st.h.numpy(), 1e-6)
        # the conv history holds x @ w_in rows, which PyTorch's CPU matmul
        # rounds by the number of rows (12 here, 1 a decode step)
        _close(st_seq.conv, st.conv.numpy(), 1e-6)
        jy, jst = jrglru.rglru_block_apply(
            jp, jnp.asarray(x.numpy()),
            jrglru.RglruState(jnp.asarray(st0.h.numpy()),
                              jnp.asarray(st0.conv.numpy())))
        _close(ys_seq, jy)
        _close(st_seq.h, jst.h)

    def test_time_mix_sequence_matches_per_step(self):
        jp = jrwkv.init_rwkv_time_mix(jax.random.PRNGKey(4), 64)
        p = _port(jp)
        rng = np.random.default_rng(5)
        x = _t((rng.normal(0, 1, (2, 6, 64)) * 0.5).astype(np.float32))
        zero = trwkv.init_rwkv_state(2, 64)
        st0 = trwkv.RwkvState(
            tm_shift=_t((rng.normal(0, 1, (2, 64)) * 0.3).astype(
                np.float32)),
            cm_shift=zero.cm_shift,
            wkv=_t((rng.normal(0, 1, zero.wkv.shape) * 0.1).astype(
                np.float32)))
        y_seq, last_seq, wkv_seq = trwkv.rwkv_time_mix(p, x, st0)
        st, ys = st0, []
        for i in range(x.shape[1]):
            y, new_last, wkv = trwkv.rwkv_time_mix(p, x[:, i:i + 1], st)
            st = trwkv.RwkvState(new_last, st.cm_shift, wkv)
            ys.append(y[:, 0])
        _close(y_seq, torch.stack(ys, 1).numpy())
        assert torch.equal(last_seq, st.tm_shift)
        _close(wkv_seq, st.wkv.numpy())
        jy, jlast, jwkv = jrwkv.rwkv_time_mix(
            jp, jnp.asarray(x.numpy()),
            jrwkv.RwkvState(*(jnp.asarray(a.numpy()) for a in st0)))
        _close(y_seq, jy)
        _close(wkv_seq, jwkv)


# -- the models ----------------------------------------------------------------

_MODELS = {}


def _model(arch, dtype="float32"):
    """JAX's reduced model of ``arch`` (seed 0), its weights carried across,
    and seeded prompts, cached for the module."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, dtype=dtype)
        jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
        tokens = np.random.default_rng(1).integers(
            0, jcfg.vocab, (2, 16)).astype(np.int32)
        _MODELS[key] = (jcfg, tcfg, jp, _port(jp), tokens)
    return _MODELS[key]


def _run_both(arch, dtype):
    """forward, prefill and four greedy decode steps (JAX's tokens fed to
    both) in both packages. Returns pairs (port, jax) of logits and the
    final caches."""
    jcfg, tcfg, jp, tp, toks = _model(arch, dtype)
    pairs = []
    jl, _ = jlm.lm_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = tlm.lm_forward(tp, tcfg, torch.from_numpy(toks))
    pairs.append((tl, jl))
    jc = jlm.init_lm_caches(jcfg, 2, 32)
    tc = tlm.init_lm_caches(tcfg, 2, 32, device="cpu")
    jl, jc = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks), tc)
    pairs.append((tl, jl))
    cur = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jlm.lm_decode(jp, jcfg, jnp.asarray(cur), jc)
        tl, tc = tlm.lm_decode(tp, tcfg, torch.from_numpy(cur), tc)
        pairs.append((tl, jl))
        cur = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    return pairs, tc, jc


@pytest.mark.parametrize("arch", PORTED)
def test_lm_forward_prefill_decode_match_jax(arch):
    """fp32: the teacher-forced forward, the prefill's last logits and
    caches, and four decode steps, leaf for leaf."""
    pairs, tc, jc = _run_both(arch, "float32")
    for got, want in pairs:
        _close(got, want, TOL_LM)
    _trees_close(tc, jc, TOL_LM)


@pytest.mark.parametrize("arch", PORTED)
def test_lm_bf16_matches_jax(arch):
    """At the configs' own bf16: every logit tensor within
    ``TOL_BF16_RMS`` (relative RMS) of JAX's bf16 path, the caches keep
    JAX's dtypes (the RWKV6 WKV state and the RG-LRU h stay fp32)."""
    pairs, tc, jc = _run_both(arch, "bfloat16")
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        assert _rel_rms(got, want) <= TOL_BF16_RMS
    assert _shapes(tc) == _shapes(jc)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_consistency_with_forward(arch):
    """decode(prefill(x)) logits equal the teacher-forced forward's (the
    property of ``tests/test_archs_smoke.py``), in the port alone."""
    _, tcfg, _, tp, toks = _model(arch)
    tokens = torch.from_numpy(toks)
    caches = tlm.init_lm_caches(tcfg, 2, 32, device="cpu")
    lg_p, caches = tlm.lm_prefill(tp, tcfg, tokens, caches)
    lg_d, caches = tlm.lm_decode(tp, tcfg, tokens[:, :1], caches)
    full, aux = tlm.lm_forward(tp, tcfg, torch.cat([tokens, tokens[:, :1]],
                                                   dim=1))
    assert full.shape == (2, 17, tcfg.vocab) and torch.isfinite(full).all()
    assert float(aux) == 0.0
    np.testing.assert_allclose(lg_p[:, 0].numpy(), full[:, 15].numpy(),
                               atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(lg_d[:, 0].numpy(), full[:, 16].numpy(),
                               atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("arch", PORTED)
def test_init_lm_tree_matches_jax(arch):
    """The port's own init (seeded on the CPU) has JAX's tree: every leaf
    path, shape and dtype, at the reduced size and in bf16; and the same
    parameter count."""
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(arch, dtype=dtype)
        jp = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
        tp = tlm.init_lm(0, tcfg, device="cpu")
        assert _shapes(tp) == _shapes(jp)
        assert tcommon.count_params(tp) == sum(
            int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    again = tlm.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(again)):
        assert torch.equal(a, b)


def test_lm_params_from_numpy_carries_every_leaf():
    jcfg, _, jp, tp, _ = _model("recurrentgemma-9b", "bfloat16")
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        np.testing.assert_array_equal(_np(t.float()), _np(j))
    jc = jlm.init_lm_caches(jcfg, 2, 8)
    tc = _port(jc)
    assert [type(c).__name__ for e in tc for c in e.values()] == [
        type(c).__name__ for e in jc for c in e.values()]
    mapped = tree_map(lambda a, b: a - b, tp, tp)
    assert all(not x.any() for x in tree_leaves(mapped))


# -- the registry --------------------------------------------------------------

class TestRegistry:
    """``tests/test_archs_smoke.py``'s registry tests on the port, and
    every config field equal to JAX's."""

    def test_all_archs_present(self):
        assert treg.ARCH_IDS == jreg.ARCH_IDS and len(treg.ARCH_IDS) == 10

    def test_grid_is_40_cells(self):
        cells = treg.grid()
        assert len(cells) == 40
        skips = [c for c in cells if c[2]]
        assert len(skips) == 8
        assert all(c[1].name == "long_500k" for c in skips)
        assert [(a, s.name, r) for a, s, r in cells] == [
            (a, s.name, r) for a, s, r in jreg.grid()]

    def test_sub_quadratic_flags(self):
        assert treg.get_config("rwkv6-1.6b").sub_quadratic
        assert treg.get_config("recurrentgemma-9b").sub_quadratic
        assert not treg.get_config("qwen2.5-32b").sub_quadratic
        assert not treg.get_config("seamless-m4t-large-v2").sub_quadratic

    def test_exact_assigned_dimensions(self):
        c = treg.get_config("qwen2.5-32b")
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
                c.vocab) == (64, 5120, 40, 8, 27648, 152064)
        c = treg.get_config("deepseek-v2-lite-16b")
        assert (c.n_layers, c.d_model, c.n_experts, c.top_k,
                c.kv_lora) == (27, 2048, 64, 6, 512)
        c = treg.get_config("recurrentgemma-9b")
        assert c.block_pattern == ("rglru", "rglru", "local_attn")
        assert (c.n_layers, c.attn_window) == (38, 2048)
        c = treg.get_config("rwkv6-1.6b")
        assert (c.n_layers, c.d_model, c.vocab) == (24, 2048, 65536)

    @pytest.mark.parametrize("arch", jreg.ARCH_IDS)
    def test_config_equals_jax(self, arch):
        import dataclasses
        for reduce in (False, True):
            j, t = jreg.get_config(arch), treg.get_config(arch)
            if reduce:
                j, t = j.reduced(), t.reduced()
            assert dataclasses.asdict(t) == dataclasses.asdict(j)

    def test_unknown_arch(self):
        with pytest.raises(KeyError, match="unknown arch"):
            treg.get_config("gpt-5")


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_archs_raise_naming_the_roadmap_item(arch):
    cfg = treg.get_config(arch).reduced()
    item = f"ROADMAP.md Queue 1 item {UNPORTED[arch]}"
    with pytest.raises(NotImplementedError, match=item):
        tlm.init_lm(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        tlm.init_lm_caches(cfg, 1, 8, device="cpu")
