"""The LM zoo's modules and models in the PyTorch port against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
come across from JAX's own init through ``lm_params_from_numpy``, leaf for
leaf. The configs are ``cfg.reduced()`` (2-3 layers, D = 64, vocab 128) of
all ten architectures of the registry; the VLM and the encoder-decoder get
seeded image embeddings / audio frames.

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
  one bf16 step. JAX's bf16 MLA decode does not run on the CPU (R21), so
  deepseek's bf16 reference is JAX's fp32 run of the same bf16 weights.
* MoE routing in bf16: the two runs' hidden states differ by ~1 % (RMS),
  so top-k over two near-tied router probabilities may choose another
  expert (R23), which moves that token's output by its own size. The port
  takes JAX's choices as they come (so one flip does not cascade through
  the later layers), and a token whose own choice differed is allowed
  only where the port's k-th and (k+1)-th probabilities lie within
  ``ROUTE_MARGIN_BF16`` = 2**-6 of each other: a probability of ~1/4 here
  moves by p * dlogit, and a logit of order 1 by up to a few 1e-2. The
  largest gaps of a flip measured here: 6.6e-3 (deepseek, bf16 against
  JAX's fp32 run) and 3.6e-4 (granite).
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
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = 1e-5
TOL_LM = 2e-5
TOL_BF16_RMS = 2 ** -3
ROUTE_MARGIN_BF16 = 2 ** -6

PORTED = tuple(jreg.ARCH_IDS)
MOE = ("deepseek-v2-lite-16b", "granite-moe-3b-a800m")
# JAX's bf16 decode fails on the CPU's dot (R21): the reference runs fp32
JAX_BF16_FAILS = ("deepseek-v2-lite-16b",)


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


def _modality(cfg, b=2, seed=9) -> dict:
    """Seeded numpy inputs of the VLM (image embeddings) and of the
    encoder-decoder (audio frames), as ``lm_batch`` scales them."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = (rng.normal(0, 1, (
            b, cfg.n_image_tokens, cfg.vision_dim)) * 0.02).astype(np.float32)
    if cfg.encdec:
        out["audio_frames"] = rng.normal(0, 1, (
            b, cfg.n_audio_frames, cfg.audio_dim)).astype(np.float32)
    return out


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
              "rglru": "recurrentgemma-9b", "rwkv": "rwkv6-1.6b",
              "cross": "llama-3.2-vision-11b", "enc": "seamless-m4t-large-v2"}
# an ``attn`` block with MLA and MoE (deepseek), and with MoE alone
# (granite: 4 of 16 experts padded), by the arch whose config makes it
BLOCK_VARIANT = {"attn_mla_moe": "deepseek-v2-lite-16b",
                 "attn_moe": "granite-moe-3b-a800m"}
BLOCK_CASES = sorted(BLOCK_ARCH) + sorted(BLOCK_VARIANT)


def _block(case):
    """``(kind, arch)`` of a block case."""
    if case in BLOCK_ARCH:
        return case, BLOCK_ARCH[case]
    return "attn", BLOCK_VARIANT[case]


def _block_cross_kv(jcfg, kind):
    """The stream a ``cross`` block attends to, at the backbone's width."""
    if kind != "cross":
        return None
    return np.random.default_rng(8).normal(
        0, 1, (2, jcfg.n_image_tokens, jcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("kind", BLOCK_CASES)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_block_matches_jax(kind, mode):
    """Output, aux loss (MoE) and new cache of one block. The encoder's
    block has no cache, so it runs in ``train`` mode only (the reference's
    prefill and decode take a cache)."""
    kind, arch = _block(kind)
    if kind == "enc" and mode != "train":
        jcfg, tcfg = _cfgs(arch)
        assert jblocks.init_block_cache(kind, jcfg, 2, 8, jnp.float32) is None
        assert tblocks.init_block_cache(kind, tcfg, 2, 8, torch.float32) \
            is None
        return
    jcfg, tcfg = _cfgs(arch, attn_window=4)
    jp = jblocks.init_block(kind, jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = _port(jp)
    rng = np.random.default_rng(6)
    s = 1 if mode == "decode" else 7
    x = rng.normal(0, 1, (2, s, jcfg.d_model)).astype(np.float32)
    ckv = _block_cross_kv(jcfg, kind)
    jkv = None if ckv is None else jnp.asarray(ckv)
    tkv = None if ckv is None else _t(ckv)
    jc = tc = None
    if mode != "train":
        jc = jblocks.init_block_cache(kind, jcfg, 2, 8, jnp.float32)
        if mode == "decode":     # a cache in use: prefill 5 tokens first
            x0 = rng.normal(0, 1, (2, 5, jcfg.d_model)).astype(np.float32)
            _, jc, _ = jblocks.apply_block(kind, jp, jnp.asarray(x0), jcfg,
                                           "prefill", jc, jkv)
        tc = _port(jc)
    jy, jnew, jaux = jblocks.apply_block(kind, jp, jnp.asarray(x), jcfg, mode,
                                         jc, jkv)
    ty, tnew, taux = tblocks.apply_block(kind, tp, _t(x), tcfg, mode, tc,
                                         tkv)
    _close(ty, jy)
    if jcfg.n_experts:
        assert float(jaux) > 0
        _close(taux, jaux)
    else:
        assert float(taux) == float(jaux) == 0.0
    if mode == "train":
        assert tnew is None and jnew is None
    else:
        _trees_close(tnew, jnew, TOL)


def test_block_init_and_cache_shapes_match_jax():
    for case in BLOCK_CASES:
        kind, arch = _block(case)
        jcfg, tcfg = _cfgs(arch)
        jp = jblocks.init_block(kind, jax.random.PRNGKey(0), jcfg,
                                jnp.float32)
        tp = tblocks.init_block(kind, torch.Generator().manual_seed(0), tcfg,
                                torch.float32)
        assert _shapes(tp) == _shapes(jp), case
        jc = jblocks.init_block_cache(kind, jcfg, 3, 40, jnp.bfloat16)
        tc = tblocks.init_block_cache(kind, tcfg, 3, 40, torch.bfloat16)
        assert type(tc).__name__ == type(jc).__name__
        if jc is None:          # the encoder's block keeps no cache
            continue
        _trees_close(tc, jc, 0.0)
        assert _shapes(tc) == _shapes(jc), case


def test_cross_prefill_needs_the_stream():
    """A ``cross`` block's prefill without ``cross_kv`` raises (the
    reference fails on ``cross_kv.shape``), and a stream whose length is not
    the cache's raises naming it."""
    _, tcfg = _cfgs("llama-3.2-vision-11b")
    tp = tblocks.init_block("cross", torch.Generator().manual_seed(0), tcfg,
                            torch.float32)
    cache = tblocks.init_block_cache("cross", tcfg, 2, 8, torch.float32)
    x = torch.zeros(2, 3, tcfg.d_model)
    with pytest.raises(ValueError, match="cross stream"):
        tblocks.apply_block("cross", tp, x, tcfg, "prefill", cache)
    with pytest.raises(ValueError, match="n_image_tokens"):
        tblocks.apply_block("cross", tp, x, tcfg, "prefill", cache,
                            torch.zeros(2, tcfg.n_image_tokens + 1,
                                        tcfg.d_model))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama-3.2-vision-11b", "rwkv6-1.6b"])
def test_init_blocks_holds_one_copy_of_the_draws(arch):
    """``init_blocks`` draws each period into its slot of stacked leaves
    allocated once; the weights are bitwise a stack of the periods drawn in
    turn by ``init_block`` from the same generator."""
    _, tcfg = _cfgs(arch, n_layers=6 if arch.startswith("llama") else 3)
    got = tblocks.init_blocks(torch.Generator().manual_seed(4), tcfg,
                              torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    want = []
    for pattern, count in tblocks.make_schedule(tcfg):
        periods = [{f"sub{j}": tblocks.init_block(kind, gen, tcfg,
                                                  torch.bfloat16)
                    for j, kind in enumerate(pattern)} for _ in range(count)]
        want.append(tree_map(lambda *xs: torch.stack(xs), *periods))
    assert _shapes(got) == _shapes(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    assert len(tree_leaves(got)) > 0


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
    seeded prompts and modality inputs, cached for the module."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, dtype=dtype)
        jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
        tokens = np.random.default_rng(1).integers(
            0, jcfg.vocab, (2, 16)).astype(np.int32)
        mod = {k: np.asarray(jnp.asarray(v).astype(dtype))
               for k, v in _modality(jcfg).items()}
        _MODELS[key] = (jcfg, tcfg, jp, _port(jp), tokens, mod)
    return _MODELS[key]


def _run_both(arch, dtype):
    """forward, prefill and four greedy decode steps (JAX's tokens fed to
    both) in both packages. Returns pairs (port, jax) of logits, the final
    caches and the forward's aux losses. Where JAX's bf16 path fails
    (``JAX_BF16_FAILS``), JAX runs the same bf16 weights and inputs in
    fp32."""
    jcfg, tcfg, jp, tp, toks, mod = _model(arch, dtype)
    if dtype == "bfloat16" and arch in JAX_BF16_FAILS:
        jcfg = jcfg.reduced(dtype="float32")
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jmod = {k: jnp.asarray(v).astype(jcfg.dtype) for k, v in mod.items()}
    tmod = {k: _t(v) for k, v in mod.items()}
    pairs = []
    jl, jaux = jlm.lm_forward(jp, jcfg, jnp.asarray(toks), **jmod)
    tl, taux = tlm.lm_forward(tp, tcfg, torch.from_numpy(toks), **tmod)
    pairs.append((tl, jl))
    jc = jlm.init_lm_caches(jcfg, 2, 32)
    tc = tlm.init_lm_caches(tcfg, 2, 32, device="cpu")
    jl, jc = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks), jc, **jmod)
    tl, tc = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks), tc, **tmod)
    pairs.append((tl, jl))
    cur = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jlm.lm_decode(jp, jcfg, jnp.asarray(cur), jc)
        tl, tc = tlm.lm_decode(tp, tcfg, torch.from_numpy(cur), tc)
        pairs.append((tl, jl))
        cur = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    return pairs, tc, jc, (taux, jaux)


@pytest.mark.parametrize("arch", PORTED)
def test_lm_forward_prefill_decode_match_jax(arch):
    """fp32: the teacher-forced forward, the prefill's last logits and
    caches, and four decode steps, leaf for leaf; the MoE aux loss within
    ``TOL``."""
    pairs, tc, jc, (taux, jaux) = _run_both(arch, "float32")
    for got, want in pairs:
        _close(got, want, TOL_LM)
    _trees_close(tc, jc, TOL_LM)
    if arch in MOE:
        assert float(jaux) > 0
        _close(taux, jaux)
    else:
        assert float(taux) == float(jaux) == 0.0


def _replay_jax_routes(monkeypatch) -> list:
    """From here on the port's router calls take JAX's choices, call by
    call (JAX's are read as it runs, through an ordered debug callback, so
    also inside its scan over layers); each gets its gates renormalized
    from its own probabilities. Returns, per call, the port's own
    probabilities and top-k and the choice it took."""
    jcalls, tcalls = [], []
    jorig, torig = jmoe._route, tmoe._route

    def jroute(p, xt, k):
        vals, idx, aux = jorig(p, xt, k)
        jax.debug.callback(lambda ix: jcalls.append(np.array(ix)), idx,
                           ordered=True)
        return vals, idx, aux

    def troute(p, xt, k):
        _, own, aux = torig(p, xt, k)
        jax.effects_barrier()
        idx = torch.from_numpy(jcalls[len(tcalls)]).long()
        probs = torch.softmax(xt.float() @ p["router"], dim=-1)
        vals = probs.gather(1, idx)
        tcalls.append((probs, own, idx))
        return vals / (vals.sum(-1, keepdim=True) + 1e-9), idx, aux

    monkeypatch.setattr(jmoe, "_route", jroute)
    monkeypatch.setattr(tmoe, "_route", troute)
    return tcalls


def _flip_gaps(tcalls) -> list:
    """The port's gap between the k-th and (k+1)-th probability of every
    token whose own top-k set was not the one it took."""
    gaps = []
    for probs, own, idx in tcalls:
        bad = (own.sort(-1).values != idx.sort(-1).values).any(-1)
        k = own.shape[1]
        p = probs[bad].sort(-1, descending=True).values
        gaps += (p[:, k - 1] - p[:, k]).tolist()
    return gaps


@pytest.mark.parametrize("arch", PORTED)
def test_lm_bf16_matches_jax(arch, monkeypatch):
    """At the configs' own bf16: every logit tensor within
    ``TOL_BF16_RMS`` (relative RMS) of JAX's bf16 path, the caches keep
    JAX's dtypes (the RWKV6 WKV state and the RG-LRU h stay fp32). MoE:
    the port takes JAX's expert choices, and each token whose own choice
    differed (a routing flip) lies within ``ROUTE_MARGIN_BF16``."""
    if arch in MOE:
        tcalls = _replay_jax_routes(monkeypatch)
    pairs, tc, _, _ = _run_both(arch, "bfloat16")
    if arch in MOE:
        assert len(tcalls) == 12          # 2 layers x (3 passes + 4 steps)
        gaps = _flip_gaps(tcalls)
        assert all(g <= ROUTE_MARGIN_BF16 for g in gaps), gaps
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        assert _rel_rms(got, want) <= TOL_BF16_RMS
    jcfg = _model(arch, "bfloat16")[0]
    assert _shapes(tc) == _shapes(jax.eval_shape(
        lambda: jlm.init_lm_caches(jcfg, 2, 32)))


@pytest.mark.parametrize("arch", PORTED)
def test_decode_consistency_with_forward(arch):
    """decode(prefill(x)) logits equal the teacher-forced forward's (the
    property of ``tests/test_archs_smoke.py``), in the port alone."""
    _, tcfg, _, tp, toks, mod = _model(arch)
    tmod = {k: _t(v) for k, v in mod.items()}
    tokens = torch.from_numpy(toks)
    caches = tlm.init_lm_caches(tcfg, 2, 32, device="cpu")
    lg_p, caches = tlm.lm_prefill(tp, tcfg, tokens, caches, **tmod)
    lg_d, caches = tlm.lm_decode(tp, tcfg, tokens[:, :1], caches)
    full, aux = tlm.lm_forward(tp, tcfg, torch.cat([tokens, tokens[:, :1]],
                                                   dim=1), **tmod)
    assert full.shape == (2, 17, tcfg.vocab) and torch.isfinite(full).all()
    assert (float(aux) > 0) if arch in MOE else (float(aux) == 0.0)
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
    _, _, jp, tp, _, _ = _model("recurrentgemma-9b", "bfloat16")
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        np.testing.assert_array_equal(_np(t.float()), _np(j))
    for arch in ("recurrentgemma-9b", "deepseek-v2-lite-16b",
                 "llama-3.2-vision-11b"):
        jc = jlm.init_lm_caches(_cfgs(arch)[0], 2, 8)
        tc = _port(jc)
        assert [type(c).__name__ for e in tc for c in e.values()] == [
            type(c).__name__ for e in jc for c in e.values()]
        _trees_close(tc, jc, 0.0)
    assert type(tc[0]["sub1"]["self"]).__name__ == "KVCache"
    assert type(_port(jlm.init_lm_caches(_cfgs("deepseek-v2-lite-16b")[0],
                                         2, 8))[0]["sub0"]).__name__ == \
        "MlaCache"
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


def test_prefill_names_the_missing_modality():
    """The VLM's prefill without ``image_embeds`` and the encoder-decoder's
    without ``audio_frames`` raise naming the input (the reference fails
    on the missing stream); decoder-only archs need neither."""
    for arch, name in (("llama-3.2-vision-11b", "image_embeds"),
                       ("seamless-m4t-large-v2", "audio_frames")):
        _, tcfg, _, tp, toks, _ = _model(arch)
        caches = tlm.init_lm_caches(tcfg, 2, 32, device="cpu")
        with pytest.raises(ValueError, match=name):
            tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks), caches)
