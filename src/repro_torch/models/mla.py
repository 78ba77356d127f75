"""Multi-head Latent Attention (DeepSeek-V2), compressed-KV attention, the
PyTorch port of :mod:`repro.models.mla`.

The forward and prefill use the uncompressed form (keys and values expanded
from the latent through ``kv_b``); decode uses the *absorbed* form
(``kv_b`` folded into the query and output projections), so the cache holds
only ``c_kv: [B, S, kv_lora]`` and ``k_rope: [B, S, qk_rope]`` a layer. Each
form is its own function, as in the reference.

The cache is written in place, as the ring KV cache is
(:mod:`repro_torch.models.attention`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.attention import NEG_INF, chunked_attention
from repro_torch.models.common import (apply_rope, dense_init, init_rmsnorm,
                                       rmsnorm)


def init_mla(generator: torch.Generator, d_model: int, n_heads: int, *,
             kv_lora: int = 512, qk_nope: int = 128, qk_rope: int = 64,
             v_dim: int = 128, dtype=torch.float32) -> dict:
    return {
        "w_q": dense_init(generator, d_model, n_heads * (qk_nope + qk_rope),
                          dtype),
        "kv_a": dense_init(generator, d_model, kv_lora + qk_rope, dtype),
        "kv_a_norm": init_rmsnorm(kv_lora, dtype, generator.device),
        "kv_b": dense_init(generator, kv_lora, n_heads * (qk_nope + v_dim),
                           dtype),
        "w_o": dense_init(generator, n_heads * v_dim, d_model, dtype),
    }


class MlaCache(NamedTuple):
    c_kv: torch.Tensor    # [B, S_max, kv_lora]
    k_rope: torch.Tensor  # [B, S_max, qk_rope], RoPE applied
    index: torch.Tensor   # [B] int32, each slot's length

    @classmethod
    def zeros(cls, batch: int, max_len: int, kv_lora: int, qk_rope: int,
              dtype, device=None) -> "MlaCache":
        return cls(
            c_kv=torch.zeros((batch, max_len, kv_lora), dtype=dtype,
                             device=device),
            k_rope=torch.zeros((batch, max_len, qk_rope), dtype=dtype,
                               device=device),
            index=torch.zeros((batch,), dtype=torch.int32, device=device))


def _project(params: dict, x: torch.Tensor, n_heads: int, kv_lora: int,
             qk_nope: int, qk_rope: int, rope_theta: float,
             positions: torch.Tensor):
    """``(q_nope, q_rope, c_kv, k_rope)`` of ``x: [B, S, D]`` at
    ``positions``: the latent normed, RoPE on the rope parts."""
    b, s, _ = x.shape
    q = (x @ params["w_q"]).reshape(b, s, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    kv = x @ params["kv_a"]
    c_kv = rmsnorm(params["kv_a_norm"], kv[..., :kv_lora])
    q_rope = apply_rope(q_rope, positions, rope_theta)
    k_rope = apply_rope(kv[..., None, kv_lora:], positions, rope_theta)[
        :, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _uncompressed(params: dict, x: torch.Tensor, n_heads: int, kv_lora: int,
                  qk_nope: int, qk_rope: int, v_dim: int, rope_theta: float,
                  q_chunk: int):
    """Causal attention with keys and values expanded from the latent (q/k
    head dim ``qk_nope + qk_rope``, v head dim ``v_dim``). Returns the
    output and the step's ``c_kv``, ``k_rope``."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None]
    q_nope, q_rope, c_kv, k_rope = _project(
        params, x, n_heads, kv_lora, qk_nope, qk_rope, rope_theta, pos)
    kv = (c_kv @ params["kv_b"]).reshape(b, s, n_heads, qk_nope + v_dim)
    k_nope, v = kv[..., :qk_nope], kv[..., qk_nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, n_heads, qk_rope)], dim=-1)
    out = chunked_attention(q, k, v, causal=True, q_chunk=q_chunk)
    y = out.reshape(b, s, n_heads * v_dim) @ params["w_o"]
    return y, c_kv, k_rope


def mla_apply(params: dict, x: torch.Tensor, *, n_heads: int,
              kv_lora: int = 512, qk_nope: int = 128, qk_rope: int = 64,
              v_dim: int = 128, rope_theta: float = 10000.0,
              q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence causal MLA (the teacher-forced forward)."""
    return _uncompressed(params, x, n_heads, kv_lora, qk_nope, qk_rope,
                         v_dim, rope_theta, q_chunk)[0]


def mla_prefill(params: dict, x: torch.Tensor, cache: MlaCache, *,
                n_heads: int, kv_lora: int = 512, qk_nope: int = 128,
                qk_rope: int = 64, v_dim: int = 128,
                rope_theta: float = 10000.0, q_chunk: int = 512):
    """Causal MLA over the prompt, then its latents into the cache's first
    ``S`` rows (in place); every slot's index becomes ``S``."""
    s = x.shape[1]
    y, c_kv, k_rope = _uncompressed(params, x, n_heads, kv_lora, qk_nope,
                                    qk_rope, v_dim, rope_theta, q_chunk)
    cache.c_kv[:, :s] = c_kv.to(cache.c_kv.dtype)
    cache.k_rope[:, :s] = k_rope.to(cache.k_rope.dtype)
    cache.index.fill_(s)
    return y, cache


def mla_decode(params: dict, x: torch.Tensor, cache: MlaCache, *,
               n_heads: int, kv_lora: int = 512, qk_nope: int = 128,
               qk_rope: int = 64, v_dim: int = 128,
               rope_theta: float = 10000.0):
    """One-token decode in the absorbed form: attention runs in the latent
    space. ``x: [B, 1, D]``.

    Each slot writes its latent at its own index; at ``index >= S_max`` the
    write is dropped (JAX's out-of-bounds scatter), and the slot attends
    over every row. The einsums over the cache run in its storage dtype
    (fp32 sums of the products), so no fp32 copy of the cache is made: in
    bf16 the two score terms are each rounded to bf16 once, where the
    reference keeps them fp32 (its other casts to bf16 are the same)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mla_decode takes one token a slot, got {s}")
    idx = cache.index.clone()                             # [B]
    q_nope, q_rope, c_new, kr_new = _project(
        params, x, n_heads, kv_lora, qk_nope, qk_rope, rope_theta,
        idx[:, None])
    s_max = cache.c_kv.shape[1]
    bi = torch.arange(b, device=x.device)
    row = idx.clamp(max=s_max - 1).long()
    fits = (idx < s_max)[:, None]
    for buf, new in ((cache.c_kv, c_new), (cache.k_rope, kr_new)):
        buf[bi, row] = torch.where(fits, new[:, 0].to(buf.dtype),
                                   buf[bi, row])
    cache.index.add_(1)

    dt = cache.c_kv.dtype
    kv_b = params["kv_b"].reshape(kv_lora, n_heads, qk_nope + v_dim)
    w_k, w_v = kv_b[..., :qk_nope], kv_b[..., qk_nope:]
    # absorb: q_eff[b, h, l] = sum_d q_nope[b, h, d] * w_k[l, h, d]
    q_eff = torch.einsum("bshd,lhd->bshl", q_nope, w_k).to(dt)
    scores = (torch.einsum("bshl,btl->bhst", q_eff, cache.c_kv).float()
              + torch.einsum("bshr,btr->bhst", q_rope.to(dt),
                             cache.k_rope).float())
    scores = scores * (qk_nope + qk_rope) ** -0.5
    valid = torch.arange(s_max, device=x.device)[None] <= idx[:, None]
    scores = scores + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(dt)
    out_c = torch.einsum("bhst,btl->bshl", probs, cache.c_kv)
    out = torch.einsum("bshl,lhv->bshv", out_c.to(w_v.dtype), w_v)
    out = out.reshape(b, 1, n_heads * v_dim).to(x.dtype)
    return out @ params["w_o"], cache
