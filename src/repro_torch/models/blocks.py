"""Block assembly: per-kind init and apply, and a loop over the layers of a
schedule, the PyTorch port of :mod:`repro.models.blocks`.

Layers are grouped into repeated *periods* (RecurrentGemma's rec-rec-attn);
each schedule entry stacks ``count`` periods, so every parameter and cache
leaf of an entry is ``[count, ...]`` as in the JAX package, and caches are
``[count, B, ...]`` (axis 1 is the slot). Where JAX scans over the stacked
axis, the port loops over it in Python.

Block kinds ported: ``attn`` (pre-norm self-attention + gated FFN),
``local_attn`` (windowed), ``rglru`` (the RG-LRU recurrent block + FFN) and
``rwkv`` (RWKV6 time-mix + channel-mix). Every block adds its output to the
residual stream after a norm. MLA and MoE (``ROADMAP.md`` Queue 1 item 5b)
and the ``cross`` / ``enc`` kinds (item 5c) are not ported:
:func:`require_ported` names the item.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
writes the cache), ``decode`` (one token against the cache). Caches are
written in place: :func:`apply_blocks` returns the stacked caches it was
given, holding the new state.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (apply_norm, init_norm, tree_leaves,
                                       tree_map)
from repro_torch.models.ffn import ffn_apply, init_ffn
from repro_torch.models.rglru import (init_rglru_block, init_rglru_state,
                                      rglru_block_apply, rglru_block_decode)
from repro_torch.models.rwkv import (RwkvState, init_rwkv_channel_mix,
                                     init_rwkv_state, init_rwkv_time_mix,
                                     rwkv_channel_mix, rwkv_time_mix)

PORTED_KINDS = ("attn", "local_attn", "rglru", "rwkv")


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


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose blocks the port
    does not have yet, naming the ``ROADMAP.md`` item that brings them."""
    if cfg.use_mla or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: latent attention (MLA) and mixture-of-experts "
            "blocks are not ported yet (ROADMAP.md Queue 1 item 5b)")
    kinds = {k for pattern, _ in make_schedule(cfg) for k in pattern}
    if cfg.encdec or not kinds <= set(PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: cross-attention and encoder blocks are not ported "
            "yet (ROADMAP.md Queue 1 item 5c)")


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
    elif kind in ("attn", "local_attn"):
        p["attn"] = attn_mod.init_attention(
            generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype=dtype, qkv_bias=cfg.qkv_bias)
    else:
        raise ValueError(f"unknown or unported block kind {kind!r}")
    p["norm2"] = init_norm(cfg.norm, d, dtype, dev)
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
        cache_len = (min(max_len, cfg.attn_window)
                     if kind == "local_attn" and cfg.attn_window else max_len)
        return KVCache.zeros(batch, cache_len, cfg.n_kv_heads, cfg.head_dim,
                             dtype, device)
    raise ValueError(f"unknown or unported block kind {kind!r}")


# ---------------------------------------------------------------------------
# Per-kind apply
# ---------------------------------------------------------------------------

def _self_attn(params: dict, h: torch.Tensor, cfg: ModelConfig, kind: str,
               mode: str, cache):
    window = cfg.attn_window if kind == "local_attn" else None
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, window=window,
              rope_theta=cfg.rope_theta)
    if mode == "train":
        return attn_mod.attention_apply(params["attn"], h, causal=True,
                                        **kw), cache
    if mode == "prefill":
        return attn_mod.attention_prefill(params["attn"], h, cache, **kw)
    if mode == "decode":
        return attn_mod.attention_decode(params["attn"], h, cache, **kw)
    raise ValueError(mode)


def apply_block(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                mode: str, cache):
    """Returns ``(x, new_cache, aux_loss)``; the new cache is ``None`` in
    ``train`` mode."""
    if kind == "rwkv":
        st = cache if cache is not None else init_rwkv_state(
            x.shape[0], cfg.d_model, x.dtype, x.device)
        h = apply_norm(cfg.norm, params["norm1"], x)
        y, tm_shift, wkv = rwkv_time_mix(params["time_mix"], h, st)
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
            y, new = rglru_block_apply(params["rglru"], h, cache)
        new = None if mode == "train" else new
    elif kind in ("attn", "local_attn"):
        y, new = _self_attn(params, h, cfg, kind, mode, cache)
    else:
        raise ValueError(f"unknown or unported block kind {kind!r}")
    x = x + y
    h = apply_norm(cfg.norm, params["norm2"], x)
    return x + ffn_apply(params["ffn"], h, activation=cfg.activation), new, 0.0


# ---------------------------------------------------------------------------
# Stacked schedule init / apply
# ---------------------------------------------------------------------------

def init_blocks(generator: torch.Generator, cfg: ModelConfig, dtype,
                schedule=None) -> list:
    """Per schedule entry: ``{"sub<j>": params stacked over count}``."""
    schedule = schedule or make_schedule(cfg)
    entries = []
    for pattern, count in schedule:
        periods = [{f"sub{j}": init_block(kind, generator, cfg, dtype)
                    for j, kind in enumerate(pattern)}
                   for _ in range(count)]
        entries.append(tree_map(lambda *xs: torch.stack(xs), *periods))
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
    cache was written in place already and is its own view)."""
    for d, n in zip(tree_leaves(dst), tree_leaves(new)):
        if d is not n:
            d.copy_(n)


def apply_blocks(entries: list, x: torch.Tensor, cfg: ModelConfig, mode: str,
                 caches: list | None = None, schedule=None):
    """Run the whole schedule. Returns ``(x, caches, total_aux)``: the
    caches given, written in place (``None`` without caches)."""
    schedule = schedule or make_schedule(cfg)
    total_aux = 0.0
    for e, ((pattern, count), params_stacked) in enumerate(
            zip(schedule, entries)):
        cache_stacked = caches[e] if caches is not None else None
        for i in range(count):
            p = tree_map(lambda t: t[i], params_stacked)
            c = tree_map(lambda t: t[i], cache_stacked)
            for j, kind in enumerate(pattern):
                sub_c = c[f"sub{j}"] if c is not None else None
                x, new_c, aux = apply_block(kind, p[f"sub{j}"], x, cfg, mode,
                                            sub_c)
                if sub_c is not None:
                    _write_back(sub_c, new_c)
                total_aux = total_aux + aux
    return x, caches, total_aux
