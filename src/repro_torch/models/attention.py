"""Attention: GQA/MQA, causal, bidirectional and local-window
self-attention, cross-attention (``kv_x``), q-chunked prefill and decode
against a ring KV cache, the PyTorch port of :mod:`repro.models.attention`.

Attention is computed as the JAX package computes it, outside any kernel:
two einsums whose products of the storage dtype are summed in fp32 and a
float32 softmax under the additive ``NEG_INF`` mask. A fully masked row is
therefore uniform, as in the reference (``scaled_dot_product_attention``
would differ there).

Under a mesh over ranks the teacher-forced forward splits the heads
(``attention_apply(..., tp=)``), as the reference's ``shard(q, ...,
"heads", None)`` / ``"kv_heads"`` annotations make GSPMD split them: each
rank of the ``heads`` group computes its query heads from its columns of
``w_q``, its key / value heads from its columns of ``w_k`` / ``w_v`` (all
of them where ``kv_heads`` does not divide), and its rows of ``w_o``; the
output is summed over the group. :func:`attention_splits` names each
leaf's part.

The cache is written in place: :func:`cache_write_prefill` and
:func:`cache_write_decode` put the new keys, values and positions into the
cache's own tensors and return the cache. A caller that needs the cache as
it was before a write (the batcher's admission) copies it first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist.ranks import psum_grads
from repro_torch.dist.sharding import Split, tp_group
from repro_torch.models.common import apply_rope, dense_init, row_parallel

NEG_INF = -1e30


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype=torch.float32,
                   qkv_bias: bool = False) -> dict:
    p = {
        "w_q": dense_init(generator, d_model, n_heads * head_dim, dtype),
        "w_k": dense_init(generator, d_model, n_kv_heads * head_dim, dtype),
        "w_v": dense_init(generator, d_model, n_kv_heads * head_dim, dtype),
        "w_o": dense_init(generator, n_heads * head_dim, d_model, dtype),
    }
    if qkv_bias:
        dev = generator.device
        p["b_q"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["b_k"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                               device=dev)
        p["b_v"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                               device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    y = x @ w
    return y if b is None else y + b


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """``[..., Sq, Sk]`` additive fp32 mask bias."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    valid = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                       dtype=torch.bool, device=qp.device)
    if causal:
        valid &= kp <= qp
    if window is not None:
        valid &= kp > qp - window
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA head grouping.

    ``q: [B, Sq, Hq, D]``, ``k/v: [B, Sk, Hkv, D]``, ``Hq % Hkv == 0``;
    ``mask_bias: [B?, Sq, Sk]`` additive (broadcast over heads). The scores
    and the output sum products of the storage dtype in fp32 (JAX's
    ``preferred_element_type=float32``); the probabilities are cast to
    ``v``'s dtype before the second product, the output to ``q``'s.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(f32),
                          k.to(f32)) * d ** -0.5
    if mask_bias is not None:
        scores = (scores + mask_bias[:, None, None] if mask_bias.ndim == 3
                  else scores + mask_bias)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).to(f32),
                       v.to(f32))
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Attention over query chunks of ``q_chunk``, which bounds the live
    score buffer to ``[B, H, q_chunk, S_kv]``. Query positions are
    ``q_offset + arange(Sq)``, key positions ``arange(Sk)``."""
    sq, sk = q.shape[1], k.shape[1]
    dev = q.device
    k_pos = torch.arange(sk, device=dev)
    outs = []
    for start in range(0, sq, q_chunk):
        stop = min(start + q_chunk, sq)
        q_pos = q_offset + torch.arange(start, stop, device=dev)
        bias = _mask_bias(q_pos, k_pos, causal, window)
        outs.append(sdpa(q[:, start:stop], k, v, bias[None]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


class KVCache(NamedTuple):
    """Ring-buffer KV cache with per-slot lengths (continuous batching).

    ``k/v: [B, W, Hkv, D]``, ``W`` the ring capacity (``max_len`` for full
    attention, the window for local attention). ``positions: [B, W]`` holds
    the absolute position stored in each ring slot (-1: empty); ``index:
    [B]`` is each slot's next absolute position. Keys are stored with RoPE
    applied at their absolute position.
    """

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor  # [B, W] int32, -1 = empty
    index: torch.Tensor      # [B] int32 next position

    @classmethod
    def zeros(cls, batch: int, max_len: int, n_kv: int, head_dim: int,
              dtype, device=None) -> "KVCache":
        shape = (batch, max_len, n_kv, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   positions=torch.full((batch, max_len), -1,
                                        dtype=torch.int32, device=device),
                   index=torch.zeros((batch,), dtype=torch.int32,
                                     device=device))

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def _qkv(params: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
         head_dim: int, kv_x: torch.Tensor | None = None):
    """Queries from ``x``, keys and values from ``kv_x`` (default ``x``)."""
    src = x if kv_x is None else kv_x
    b, s, _ = x.shape
    sk = src.shape[1]
    q = _proj(x, params["w_q"], params.get("b_q"))
    k = _proj(src, params["w_k"], params.get("b_k"))
    v = _proj(src, params["w_v"], params.get("b_v"))
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, sk, n_kv_heads, head_dim),
            v.reshape(b, sk, n_kv_heads, head_dim))


def _kv_heads_of(k: torch.Tensor, v: torch.Tensor, first: int, heads: int,
                 group: int):
    """The key / value heads (all ``Hkv`` of them in ``k`` / ``v``) that
    the query heads ``first .. first + heads - 1`` read, GQA's ``group``
    query heads a KV head, as ``sdpa``'s grouping wants them: a run of
    whole groups, one head that every local query head shares, or else
    one KV head a query head."""
    if heads % group == 0 or group % heads == 0:
        lo = first // group
        n = max(heads // group, 1)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = (first + torch.arange(heads, device=k.device)) // group
    return k[:, :, idx], v[:, :, idx]


def attention_splits(params: dict, n_heads: int, n_kv_heads: int) -> dict:
    """Each leaf's :class:`~repro_torch.dist.sharding.Split` in
    ``attention_apply`` on the active mesh, or None for every leaf where
    the ranks do not split the heads: ``w_q`` / ``b_q`` by columns and
    ``w_o`` by rows over the ``heads`` group; ``w_k``, ``w_v``, ``b_k``,
    ``b_v`` by columns where ``kv_heads`` splits over the same axes, else
    whole on the split side."""
    heads = tp_group("heads", n_heads)
    kv = tp_group("kv_heads", n_kv_heads)

    def one(name):
        if heads is None:
            return None
        if name in ("w_q", "b_q"):
            return Split(-1, heads)
        if name == "w_o":
            return Split(-2, heads)
        if kv is not None and kv.names == heads.names:
            return Split(-1, kv)
        return Split(None, heads)
    return {k: one(k) for k in params}


def attention_apply(params: dict, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int, causal: bool = True,
                    window: int | None = None,
                    rope_theta: float | None = 10000.0, q_chunk: int = 512,
                    positions: torch.Tensor | None = None,
                    kv_x: torch.Tensor | None = None,
                    tp=None) -> torch.Tensor:
    """Full-sequence attention (the teacher-forced forward and the encoder,
    ``causal=False``). ``kv_x`` switches to cross-attention: keys and values
    from the other stream, no RoPE and no mask (still q-chunked).

    ``tp`` (a ``sharding.TpGroup``, the ``heads`` split of
    :func:`attention_splits`): ``params`` holds this rank's slices, and the
    rank computes its ``n_heads / parts`` query heads, local head ``j``
    being global head ``index * H / parts + j`` and reading the KV head of
    its global index (its slice of the KV heads, or all of them where
    ``w_k`` holds all); ``x`` and ``kv_x`` go through ``ranks.psum_grads``
    and the output through ``ranks.psum_disjoint``."""
    b, s, _ = x.shape
    heads, kv_heads = n_heads, n_kv_heads
    if tp is not None:
        heads = n_heads // tp.parts
        kv_heads = params["w_k"].shape[-1] // head_dim
        x = psum_grads(x, tp.group)
        if kv_x is not None:
            kv_x = psum_grads(kv_x, tp.group)
    q, k, v = _qkv(params, x, heads, kv_heads, head_dim, kv_x)
    if heads < n_heads and kv_heads == n_kv_heads:
        # every KV head: those the rank's query heads read
        k, v = _kv_heads_of(k, v, tp.index * heads, heads,
                            n_heads // n_kv_heads)
    if kv_x is not None:
        causal, window = False, None
    elif rope_theta is not None:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device)[None])
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            q_chunk=q_chunk)
    return row_parallel(out.reshape(b, s, heads * head_dim), params["w_o"],
                        tp)


def cache_write_prefill(cache: KVCache, k: torch.Tensor,
                        v: torch.Tensor) -> KVCache:
    """Write a length-``s`` prefill into the ring, in place (it keeps the
    last ``W`` positions); every slot's index becomes ``s``."""
    s = k.shape[1]
    w = cache.capacity
    m = min(s, w)
    pos = s - m + torch.arange(m, device=k.device)   # absolute positions kept
    slots = pos % w
    cache.k[:, slots] = k[:, s - m:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, s - m:].to(cache.v.dtype)
    cache.positions[:, slots] = pos.to(torch.int32)
    cache.index.fill_(s)
    return cache


def cache_write_decode(cache: KVCache, k: torch.Tensor,
                       v: torch.Tensor) -> KVCache:
    """Write one token per slot at each slot's own position (ragged), in
    place, and advance every index by one."""
    b = k.shape[0]
    bi = torch.arange(b, device=k.device)
    slots = (cache.index % cache.capacity).long()
    cache.k[bi, slots] = k[:, 0].to(cache.k.dtype)
    cache.v[bi, slots] = v[:, 0].to(cache.v.dtype)
    cache.positions[bi, slots] = cache.index
    cache.index.add_(1)
    return cache


def attention_prefill(params: dict, x: torch.Tensor, cache: KVCache, *,
                      n_heads: int, n_kv_heads: int, head_dim: int,
                      window: int | None = None,
                      rope_theta: float | None = 10000.0, q_chunk: int = 512):
    """Prefill: causal attention over the prompt (positions from 0, no pad
    mask), then its keys and values into the cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv_heads, head_dim)
    if rope_theta is not None:
        pos = torch.arange(s, device=x.device)[None]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            q_chunk=q_chunk)
    cache = cache_write_prefill(cache, k, v)
    return out.reshape(b, s, n_heads * head_dim) @ params["w_o"], cache


def attention_decode(params: dict, x: torch.Tensor, cache: KVCache, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     window: int | None = None,
                     rope_theta: float | None = 10000.0):
    """One-token decode against the ring cache. ``x: [B, 1, D]``."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one token a slot, got {s}")
    idx = cache.index.clone()                           # [B]
    q, k, v = _qkv(params, x, n_heads, n_kv_heads, head_dim)
    if rope_theta is not None:
        pos = idx[:, None]                              # [B, 1]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    cache = cache_write_decode(cache, k, v)
    kpos = cache.positions                              # [B, W]
    valid = (kpos >= 0) & (kpos <= idx[:, None])
    if window is not None:
        valid &= kpos > (idx[:, None] - window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[:, None, :]
    out = sdpa(q, cache.k.to(q.dtype), cache.v.to(q.dtype), bias)
    return out.reshape(b, 1, n_heads * head_dim) @ params["w_o"], cache
