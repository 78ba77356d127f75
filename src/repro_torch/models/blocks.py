"""Block assembly: per-kind init and apply, and a loop over the layers of a
schedule, the PyTorch port of :mod:`repro.models.blocks`.

Layers are grouped into repeated *periods* (RecurrentGemma's rec-rec-attn,
the VLM's four self-attention layers and a cross-attention one); each
schedule entry stacks ``count`` periods, so every parameter and cache leaf
of an entry is ``[count, ...]`` as in the JAX package, and caches are
``[count, B, ...]`` (axis 1 is the slot). Where JAX scans over the stacked
axis, the port loops over it in Python.

Block kinds: ``attn`` (pre-norm self-attention, or MLA with
``cfg.use_mla``, + a gated FFN, or MoE with ``cfg.n_experts``),
``local_attn`` (windowed), ``cross`` (self-attention + cross-attention to
the modality stream + FFN), ``enc`` (bidirectional self-attention + FFN,
the audio encoder), ``rglru`` (the RG-LRU recurrent block + FFN) and
``rwkv`` (RWKV6 time-mix + channel-mix). Every block adds its output to the
residual stream after a norm.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
writes the cache), ``decode`` (one token against the cache). Caches are
written in place: :func:`apply_blocks` returns the stacked caches it was
given, holding the new state. A ``cross`` block's cache is ``{"ck", "cv",
"self"}``: the cross stream's keys and values, written at prefill and read
by every decode step, and the self-attention ring.

The scans of the ``rwkv`` and ``rglru`` blocks: :func:`apply_block` picks
the version by name. Where autograd would record the scan (grad mode on,
and the block's input or one of its parameters requires grad: a train
step), it calls the plain, differentiable scan, as the reference's blocks
do (``use_kernel=False``, a ``lax.scan`` that ``jax.value_and_grad``
differentiates); everywhere else (serving, with or without grad mode) it
calls :mod:`repro_torch.kernels.ops`' scan, the CUDA kernel on a CUDA
device. This is a choice made before the call, not a fallback: a kernel
that fails still raises, and the kernel itself refuses operands that
require grad.

In ``train`` mode with ``cfg.remat == "full"`` and grad mode on,
:func:`apply_blocks` runs each period's body under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` on its scan body: the period's activations
are recomputed in the backward instead of kept.

Given the specs of a parameter state laid out over ranks (FSDP),
:func:`apply_blocks` takes each period's blocks and gathers them as the
first thing in the period's body (``sharding.gather_tree``), inside the
checkpoint: the recompute gathers again, so nothing gathered is kept, and
the backward of each gather reduce-scatters the period's gradients as soon
as they exist. A stacked leaf whose period dim is itself sharded (a norm's
``[count, D]`` scale, which the layout spreads over ``data``) has period
``i`` on one rank only: such leaves are gathered whole, once an entry,
before the periods.

Given the leaves' splits (:func:`entry_splits`; ``lm.lm_forward`` gives
them on a mesh over ranks), :func:`apply_blocks` runs the tensor-parallel
``train`` forward: each period's gather hands the blocks the rank's
slices of the split leaves (the heads of self, local, encoder and cross
attention, the FFN columns, the MoE's shared experts) and gathers none of
them over the split's axes, and the blocks compute with them over the
groups the splits carry. The MLA, RWKV6 and RG-LRU mixers, the routers and the
routed experts run whole on every rank of the split, as before.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (P, _map_with_path, current_mesh,
                                       gather_tree, sharded_dims)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (apply_norm, init_norm, tree_leaves,
                                       tree_map)
from repro_torch.models.ffn import ffn_apply, ffn_splits, init_ffn
from repro_torch.models.mla import MlaCache
from repro_torch.models.moe import init_moe, moe_apply_auto
from repro_torch.models.rglru import (init_rglru_block, init_rglru_state,
                                      rglru_block_apply, rglru_block_decode)
from repro_torch.models.rwkv import (RwkvState, init_rwkv_channel_mix,
                                     init_rwkv_state, init_rwkv_time_mix,
                                     rwkv_channel_mix, rwkv_time_mix)

# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def make_schedule(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """``[(pattern, count), ...]``: each entry is ``count`` periods of the
    block kinds in ``pattern``."""
    if cfg.cross_attn_every:
        period = ("attn",) * (cfg.cross_attn_every - 1) + ("cross",)
        n, rem = divmod(cfg.n_layers, cfg.cross_attn_every)
        sched = [(period, n)]
        if rem:
            sched.append((("attn",) * rem, 1))
        return sched
    if cfg.block_pattern != ("attn",):
        p = tuple(cfg.block_pattern)
        n, rem = divmod(cfg.n_layers, len(p))
        sched = [(p, n)] if n else []
        if rem:
            sched.append((p[:rem], 1))
        return sched
    return [(("attn",), cfg.n_layers)]


def _uses_moe(cfg: ModelConfig, kind: str) -> bool:
    return cfg.n_experts > 0 and kind in ("attn", "local_attn")


# ---------------------------------------------------------------------------
# Per-kind init
# ---------------------------------------------------------------------------

def init_block(kind: str, generator: torch.Generator, cfg: ModelConfig,
               dtype) -> dict:
    """One block's parameters, drawn from ``generator`` on its device."""
    d, dev = cfg.d_model, generator.device
    p = {"norm1": init_norm(cfg.norm, d, dtype, dev)}
    if kind == "rwkv":
        p["time_mix"] = init_rwkv_time_mix(generator, d, dtype)
        p["norm2"] = init_norm(cfg.norm, d, dtype, dev)
        p["channel_mix"] = init_rwkv_channel_mix(generator, d, cfg.d_ff,
                                                 dtype)
        return p
    if kind == "rglru":
        p["rglru"] = init_rglru_block(generator, d, d, dtype)
    elif kind in ("attn", "local_attn", "enc"):
        if cfg.use_mla:
            p["attn"] = mla_mod.init_mla(
                generator, d, cfg.n_heads, kv_lora=cfg.kv_lora,
                qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                v_dim=cfg.v_head_dim, dtype=dtype)
        else:
            p["attn"] = attn_mod.init_attention(
                generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                dtype=dtype, qkv_bias=cfg.qkv_bias)
    elif kind == "cross":
        p["attn"] = attn_mod.init_attention(
            generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype=dtype, qkv_bias=cfg.qkv_bias)
        p["norm_x"] = init_norm(cfg.norm, d, dtype, dev)
        p["xattn"] = attn_mod.init_attention(
            generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype=dtype)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p["norm2"] = init_norm(cfg.norm, d, dtype, dev)
    if _uses_moe(cfg, kind):
        p["moe"] = init_moe(generator, d, cfg.expert_d_ff, cfg.n_experts,
                            n_shared=cfg.n_shared_experts, dtype=dtype)
    else:
        p["ffn"] = init_ffn(generator, d, cfg.d_ff, gated=True, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# Per-kind caches
# ---------------------------------------------------------------------------

def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device=None):
    if kind == "rwkv":
        return init_rwkv_state(batch, cfg.d_model, dtype, device)
    if kind == "rglru":
        return init_rglru_state(batch, cfg.d_model, dtype, device)
    if kind in ("attn", "local_attn"):
        if cfg.use_mla:
            return MlaCache.zeros(batch, max_len, cfg.kv_lora, cfg.qk_rope,
                                  dtype, device)
        cache_len = (min(max_len, cfg.attn_window)
                     if kind == "local_attn" and cfg.attn_window else max_len)
        return KVCache.zeros(batch, cache_len, cfg.n_kv_heads, cfg.head_dim,
                             dtype, device)
    if kind == "cross":
        shape = (batch, cfg.n_image_tokens or cfg.n_audio_frames,
                 cfg.n_kv_heads, cfg.head_dim)
        return {"ck": torch.zeros(shape, dtype=dtype, device=device),
                "cv": torch.zeros(shape, dtype=dtype, device=device),
                "self": KVCache.zeros(batch, max_len, cfg.n_kv_heads,
                                      cfg.head_dim, dtype, device)}
    if kind == "enc":
        return None
    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Per-kind apply
# ---------------------------------------------------------------------------

def _ffn_or_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                tp=None):
    """The block's FFN, or its MoE; returns ``(y, aux_loss)``. ``tp``: the
    FFN's (or the shared experts') ``ff`` group, or None."""
    if _uses_moe(cfg, kind):
        return moe_apply_auto(params["moe"], x, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              activation=cfg.activation, tp=tp)
    return ffn_apply(params["ffn"], x, activation=cfg.activation, tp=tp), 0.0


def _self_attn(params: dict, h: torch.Tensor, cfg: ModelConfig, kind: str,
               mode: str, cache, tp=None):
    if cfg.use_mla and kind != "cross":
        kw = dict(n_heads=cfg.n_heads, kv_lora=cfg.kv_lora,
                  qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                  v_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta)
        if mode == "train":
            return mla_mod.mla_apply(params["attn"], h, **kw), cache
        if mode == "prefill":
            return mla_mod.mla_prefill(params["attn"], h, cache, **kw)
        if mode == "decode":
            return mla_mod.mla_decode(params["attn"], h, cache, **kw)
        raise ValueError(mode)
    window = cfg.attn_window if kind == "local_attn" else None
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, window=window,
              rope_theta=cfg.rope_theta)
    if mode == "train":
        return attn_mod.attention_apply(params["attn"], h,
                                        causal=(kind != "enc"), tp=tp,
                                        **kw), cache
    if mode == "prefill":
        return attn_mod.attention_prefill(params["attn"], h, cache, **kw)
    if mode == "decode":
        return attn_mod.attention_decode(params["attn"], h, cache, **kw)
    raise ValueError(mode)


def _cross_attn(params: dict, h: torch.Tensor, cfg: ModelConfig, mode: str,
                cache, cross_kv, tp=None):
    """The cross-attention of a ``cross`` block. Prefill computes the
    stream's keys and values and writes them into ``cache["ck"]`` /
    ``["cv"]``; decode attends over those (no mask, no RoPE). Returns
    ``(y, ck, cv)``, the last two ``None`` without a cache."""
    b, s, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xp = params["xattn"]
    if mode == "decode":
        q = (h @ xp["w_q"]).reshape(b, s, hq, hd)
        out = attn_mod.sdpa(q, cache["ck"].to(q.dtype),
                            cache["cv"].to(q.dtype))
        return out.reshape(b, s, -1) @ xp["w_o"], cache["ck"], cache["cv"]
    if cache is not None and cross_kv is None:
        raise ValueError("a cross block's prefill needs the cross stream "
                         "(cross_kv)")
    y = attn_mod.attention_apply(xp, h, n_heads=hq, n_kv_heads=hkv,
                                 head_dim=hd, rope_theta=None, kv_x=cross_kv,
                                 tp=tp)
    if cache is None:
        return y, None, None
    n = cross_kv.shape[1]
    if n != cache["ck"].shape[1]:
        raise ValueError(f"a cross stream of {n} positions; the cache holds "
                         f"{cache['ck'].shape[1]} (n_image_tokens or "
                         "n_audio_frames)")
    ck = (cross_kv @ xp["w_k"]).reshape(b, n, hkv, hd)
    cv = (cross_kv @ xp["w_v"]).reshape(b, n, hkv, hd)
    return y, ck.to(cache["ck"].dtype), cv.to(cache["cv"].dtype)


def _records_grad(params: dict, x: torch.Tensor) -> bool:
    """True when autograd would record a function of ``x`` and ``params``:
    grad mode is on and ``x`` or a parameter leaf requires grad."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in tree_leaves(params)))


def _tp(splits, *path):
    """The group of the :class:`~repro_torch.dist.sharding.Split` at
    ``path`` in a block's splits, or None."""
    for k in path:
        splits = splits.get(k) if isinstance(splits, dict) else None
    return None if splits is None else splits.tp


def apply_block(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                mode: str, cache, cross_kv: torch.Tensor | None = None,
                splits: dict | None = None):
    """Returns ``(x, new_cache, aux_loss)``; the new cache is ``None`` in
    ``train`` mode. ``cross_kv`` is the modality stream a ``cross`` block
    attends to in ``train`` and ``prefill`` (without it, in ``train``, the
    block's cross-attention attends to ``x`` itself, as the reference's
    does). An ``rwkv`` or ``rglru`` block calls the plain scan where
    autograd would record it, and the kernel's entry otherwise (the module
    docstring). ``splits`` (``train`` mode): the block's
    :func:`block_splits`; ``params`` holds the rank's slices of the leaves
    they split, and the attention and FFN compute theirs over the groups
    the splits carry."""
    use_kernel = (kind in ("rwkv", "rglru")
                  and not _records_grad(params, x))
    if kind == "rwkv":
        st = cache if cache is not None else init_rwkv_state(
            x.shape[0], cfg.d_model, x.dtype, x.device)
        h = apply_norm(cfg.norm, params["norm1"], x)
        y, tm_shift, wkv = rwkv_time_mix(params["time_mix"], h, st,
                                         use_kernel=use_kernel)
        x = x + y
        h = apply_norm(cfg.norm, params["norm2"], x)
        y, cm_shift = rwkv_channel_mix(params["channel_mix"], h, st.cm_shift)
        new = RwkvState(tm_shift=tm_shift, cm_shift=cm_shift, wkv=wkv)
        return x + y, (new if cache is not None else None), 0.0

    h = apply_norm(cfg.norm, params["norm1"], x)
    if kind == "rglru":
        if mode == "decode":
            y, new = rglru_block_decode(params["rglru"], h, cache)
        else:
            y, new = rglru_block_apply(params["rglru"], h, cache,
                                       use_kernel=use_kernel)
        new = None if mode == "train" else new
    elif kind == "cross":
        y, sa = _self_attn(params, h, cfg, "attn", mode,
                           cache["self"] if cache is not None else None,
                           _tp(splits, "attn", "w_q"))
        x = x + y
        h = apply_norm(cfg.norm, params["norm_x"], x)
        y, ck, cv = _cross_attn(params, h, cfg, mode, cache, cross_kv,
                                _tp(splits, "xattn", "w_q"))
        new = None if cache is None else {"ck": ck, "cv": cv, "self": sa}
    elif kind in ("attn", "local_attn", "enc"):
        y, new = _self_attn(params, h, cfg, kind, mode, cache,
                            _tp(splits, "attn", "w_q"))
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x = x + y
    h = apply_norm(cfg.norm, params["norm2"], x)
    y, aux = _ffn_or_moe(params, h, cfg, kind,
                         _tp(splits, "ffn", "w_up")
                         or _tp(splits, "moe", "shared", "w_up"))
    return x + y, new, aux


def block_splits(kind: str, params: dict, cfg: ModelConfig) -> dict:
    """Each leaf's :class:`~repro_torch.dist.sharding.Split` (or None) in
    ``apply_block(kind, params, ...)`` on the active mesh, a tree shaped
    like ``params`` (a block's leaves, or its stacked ones)."""
    out = tree_map(lambda _: None, params)
    if kind == "cross" or (kind in ("attn", "local_attn", "enc")
                           and not cfg.use_mla):
        out["attn"] = attn_mod.attention_splits(params["attn"], cfg.n_heads,
                                                cfg.n_kv_heads)
    if kind == "cross":
        out["xattn"] = attn_mod.attention_splits(
            params["xattn"], cfg.n_heads, cfg.n_kv_heads)
    if "ffn" in params:
        out["ffn"] = ffn_splits(params["ffn"], cfg.d_ff)
    if "moe" in params and "shared" in params["moe"]:
        out["moe"]["shared"] = ffn_splits(
            params["moe"]["shared"], cfg.n_shared_experts * cfg.expert_d_ff)
    return out


def entry_splits(entries: list, cfg: ModelConfig, schedule=None) -> list:
    """:func:`block_splits` of every block of a schedule's stacked entries
    (``init_blocks``' tree, or this rank's blocks of it)."""
    schedule = schedule or make_schedule(cfg)
    return [{f"sub{j}": block_splits(kind, entry[f"sub{j}"], cfg)
             for j, kind in enumerate(pattern)}
            for (pattern, _), entry in zip(schedule, entries)]


# ---------------------------------------------------------------------------
# Stacked schedule init / apply
# ---------------------------------------------------------------------------

def init_blocks(generator: torch.Generator, cfg: ModelConfig, dtype,
                schedule=None) -> list:
    """Per schedule entry: ``{"sub<j>": params stacked over count}``. Each
    stacked leaf is allocated once and each period drawn into its slot, so
    the weights are held once (not again as a list of periods); the draws
    are those of drawing every period in turn and stacking them."""
    schedule = schedule or make_schedule(cfg)
    entries = []
    for pattern, count in schedule:
        stacked = None
        for i in range(count):
            period = {f"sub{j}": init_block(kind, generator, cfg, dtype)
                      for j, kind in enumerate(pattern)}
            if stacked is None:
                stacked = tree_map(
                    lambda t: t.new_empty((count,) + tuple(t.shape)), period)
            tree_map(lambda dst, src: dst[i].copy_(src), stacked, period)
            del period
        entries.append(stacked)
    return entries


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None, schedule=None) -> list:
    """Per schedule entry: ``{"sub<j>": cache stacked [count, B, ...]}``
    (zeros, empty rings)."""
    schedule = schedule or make_schedule(cfg)
    caches = []
    for pattern, count in schedule:
        entry = {}
        for j, kind in enumerate(pattern):
            c = init_block_cache(kind, cfg, batch, max_len, dtype, device)
            entry[f"sub{j}"] = tree_map(
                lambda t: t[None].repeat((count,) + (1,) * t.ndim), c)
        caches.append(entry)
    return caches


def _write_back(dst, new) -> None:
    """Copy a block's new cache into its views of the stacked caches (a KV
    or MLA cache was written in place already and is its own view)."""
    for d, n in zip(tree_leaves(dst), tree_leaves(new)):
        if d is not n:
            d.copy_(n)


def _periods(stacked, count: int) -> list:
    """The ``count`` periods of a stacked parameter tree, as views. Taken
    with one ``unbind`` a leaf: under autograd its backward stacks the
    periods' gradients once, where indexing each period would add a
    zero-padded gradient of the whole stacked leaf a period."""
    split = [t.unbind(0) for t in tree_leaves(stacked)]
    periods = []
    for i in range(count):
        it = iter([s[i] for s in split])
        periods.append(tree_map(lambda _: next(it), stacked))
    return periods


def _period_specs(stacked, specs, splits=None):
    """``(stacked, period specs, period splits)`` of a schedule entry laid
    out by ``specs``: a leaf whose stacked dim is sharded gathered whole
    (to the rank's slice where ``splits`` cuts it; its periods then need no
    gather), every other leaf as it is with its spec less the stacked
    dim. The period splits are None without ``splits``."""
    mesh = current_mesh()
    whole = _map_with_path(
        lambda _, x, s: mesh is not None and any(
            d == 0 for d, _ in sharded_dims(s, mesh)), stacked, specs)
    if splits is None:
        stacked = _map_with_path(
            lambda path, x, s, w: gather_tree(x, s) if w else x, stacked,
            specs, whole)
        period_splits = None
    else:
        stacked = _map_with_path(
            lambda path, x, s, w, sp: gather_tree(x, s, sp) if w else x,
            stacked, specs, whole, splits)
        period_splits = _map_with_path(
            lambda _, x, w, sp: None if w else sp, stacked, whole, splits)
    return stacked, _map_with_path(
        lambda _, s, w: P() if w else P(*list(s)[1:]), specs, whole), \
        period_splits


def apply_blocks(entries: list, x: torch.Tensor, cfg: ModelConfig, mode: str,
                 caches: list | None = None,
                 cross_kv: torch.Tensor | None = None, schedule=None,
                 specs: list | None = None, splits: list | None = None):
    """Run the whole schedule. Returns ``(x, caches, total_aux)``: the
    caches given, written in place (``None`` without caches). In ``train``
    mode with ``cfg.remat == "full"`` and grad mode on, each period runs
    under ``torch.utils.checkpoint`` (the module docstring). ``specs``:
    the entries' layout over the ranks (one tree of specs an entry) when
    ``entries`` holds this rank's blocks of it; their periods are gathered
    (the module docstring). ``splits`` (``train`` mode, with ``specs``):
    :func:`entry_splits` on a mesh over ranks, the tensor-parallel
    forward."""
    if splits is not None and (mode != "train" or specs is None):
        raise ValueError("the split forward is the train mode's, over a "
                         "layout (specs)")
    schedule = schedule or make_schedule(cfg)
    remat = (mode == "train" and cfg.remat == "full"
             and torch.is_grad_enabled())
    total_aux = 0.0
    for e, ((pattern, count), params_stacked) in enumerate(
            zip(schedule, entries)):
        cache_stacked = caches[e] if caches is not None else None
        period_specs = period_splits = None
        if specs is not None:
            params_stacked, period_specs, period_splits = _period_specs(
                params_stacked, specs[e],
                splits[e] if splits is not None else None)

        # ``pattern`` bound now: the checkpoint recomputes a period in the
        # backward, after the loop has moved on to the next entry
        def period(x, aux, p, c, pattern=pattern, sp=period_specs,
                   ss=period_splits,
                   bs=splits[e] if splits is not None else None):
            p = gather_tree(p, sp, ss)
            for j, kind in enumerate(pattern):
                sub_c = c[f"sub{j}"] if c is not None else None
                x, new_c, a = apply_block(
                    kind, p[f"sub{j}"], x, cfg, mode, sub_c, cross_kv,
                    bs[f"sub{j}"] if bs is not None else None)
                if sub_c is not None:
                    _write_back(sub_c, new_c)
                aux = aux + a
            return x, aux

        for i, p in enumerate(_periods(params_stacked, count)):
            c = tree_map(lambda t: t[i], cache_stacked)
            if remat:
                # no block draws random numbers, so there is no RNG state
                # to stash and restore for the recompute; restoring it sets
                # the CUDA generator's state, which PyTorch refuses while a
                # CUDA graph is being captured (a compiled train step)
                x, total_aux = checkpoint(period, x, total_aux, p, c,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
            else:
                x, total_aux = period(x, total_aux, p, c)
    return x, caches, total_aux
