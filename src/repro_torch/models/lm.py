"""Language models over the block schedule, the PyTorch port of
:mod:`repro.models.lm`: the decoder-only archs (dense, MoE, MLA, hybrid,
RWKV6), the VLM (cross-attention blocks over projected image embeddings)
and the encoder-decoder (an encoder over projected audio frames, and
cross-attention decoder blocks over its output).

One init and three entry points: the teacher-forced forward, prefill and
decode, pure functions of the parameters except that prefill and decode
write the caches in place (and return them). The modality frontends are
stubs, as in the reference: ``image_embeds`` / ``audio_frames`` arrive
precomputed, in the model's dtype. :func:`init_lm` and
:func:`init_lm_caches` run on the card unless given ``device="cpu"``.
:func:`lm_params_from_numpy` carries a JAX ``init_lm`` tree (or a cache
tree) across leaf for leaf, so the two packages can run the same weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (_axis_extent, current_mesh,
                                       current_rules, shard)
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import apply_blocks, init_blocks, init_caches
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       init_norm)
from repro_torch.models.mla import MlaCache
from repro_torch.models.rglru import RglruState
from repro_torch.models.rwkv import RwkvState

# the cache and state NamedTuples of the JAX package, by name
_NAMED = {cls.__name__: cls
          for cls in (KVCache, MlaCache, RwkvState, RglruState)}


def lm_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _generator(generator, device: torch.device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"a generator on {generator.device} cannot "
                             f"draw weights for {device}")
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def _encoder_schedule(cfg: ModelConfig):
    return [(("enc",), cfg.n_encoder_layers)]


def init_lm(generator, cfg: ModelConfig, device=None) -> dict:
    """Parameters of any arch of the registry, drawn on ``device`` (default
    ``"cuda"``) from ``generator`` (a ``torch.Generator`` of that device, or
    an int seed). A CUDA generator gives other numbers than a CPU one of the
    same seed."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    dt = lm_dtype(cfg)
    params = {
        "embedding": embed_init(gen, cfg.vocab, cfg.d_model, dt),
        "blocks": init_blocks(gen, cfg, dt),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, dt)
    if cfg.cross_attn_every:
        params["img_proj"] = dense_init(gen, cfg.vision_dim or cfg.d_model,
                                        cfg.d_model, dt)
    if cfg.encdec:
        params["audio_proj"] = dense_init(gen, cfg.audio_dim or 80,
                                          cfg.d_model, dt)
        enc_cfg = dataclasses.replace(
            cfg, block_pattern=("enc",), cross_attn_every=0, n_experts=0,
            use_mla=False)
        params["encoder"] = {
            "blocks": init_blocks(gen, enc_cfg, dt,
                                  schedule=_encoder_schedule(cfg)),
            "final_norm": init_norm(cfg.norm, cfg.d_model, dt, dev),
        }
    return params


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].T
    else:
        logits = x @ params["lm_head"]
    return shard(logits, "batch", "seq", "vocab")


def _embed(params: dict, tokens: torch.Tensor,
           mode: str = "train") -> torch.Tensor:
    """Embedding lookup, sharding-aware, as the reference's.

    Training with a vocab-sharded table (a mesh whose ``vocab`` extent is
    above 1 and divides the vocabulary) contracts a one-hot: its gradient
    is then a matmul, not a scatter. A one-hot row picks its embedding row
    exactly, so the forward equals the gather's bitwise. Otherwise, and in
    the no-grad modes (``"prefill"`` / ``"decode"``), a gather."""
    emb = params["embedding"]
    v = emb.shape[0]
    mesh = current_mesh()
    vocab_sharded = False
    if mesh is not None:
        ext = _axis_extent(mesh, current_rules().resolve("vocab",
                                                         mesh=mesh)[0])
        vocab_sharded = ext > 1 and v % ext == 0
    tokens = tokens.long()
    if mode == "train" and vocab_sharded:
        onehot = torch.zeros(*tokens.shape, v, dtype=emb.dtype,
                             device=emb.device).scatter_(
            -1, tokens[..., None], 1.0)
        onehot = shard(onehot, "batch", "seq", "vocab")
        return shard(onehot @ emb, "batch", "seq", "embed")
    return shard(emb[tokens], "batch", "seq", "embed")


def _cross_stream(params: dict, cfg: ModelConfig, image_embeds,
                  audio_frames):
    """The modality stream in the backbone's width: the projected image
    embeddings, or the encoder's output over the projected audio frames
    (``None`` without one)."""
    if cfg.cross_attn_every and image_embeds is not None:
        return image_embeds @ params["img_proj"]
    if cfg.encdec and audio_frames is not None:
        h = audio_frames @ params["audio_proj"]
        enc_cfg = dataclasses.replace(cfg, n_experts=0, use_mla=False)
        h, _, _ = apply_blocks(params["encoder"]["blocks"], h, enc_cfg,
                               "train", schedule=_encoder_schedule(cfg))
        return apply_norm(cfg.norm, params["encoder"]["final_norm"], h)
    return None


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
               image_embeds: torch.Tensor | None = None,
               audio_frames: torch.Tensor | None = None):
    """Teacher-forced forward. Returns ``(logits [B, S, V], aux_loss)``
    (the MoE load-balance loss summed over the layers; 0 without MoE).

    The VLM's ``cross`` blocks attend to ``image_embeds [B, N, vision_dim]``
    projected, the encoder-decoder's to the encoder's output over
    ``audio_frames [B, N, audio_dim]``."""
    x = _embed(params, tokens, "train")
    cross_kv = _cross_stream(params, cfg, image_embeds, audio_frames)
    x, _, aux = apply_blocks(params["blocks"], x, cfg, "train",
                             cross_kv=cross_kv)
    return _logits(params, cfg, x), aux


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> list:
    """Empty caches for ``batch`` slots of ``max_len`` tokens on ``device``
    (default ``"cuda"``)."""
    return init_caches(cfg, batch, max_len, lm_dtype(cfg),
                       resolve_device(device))


def lm_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               caches: list, *, image_embeds: torch.Tensor | None = None,
               audio_frames: torch.Tensor | None = None):
    """Process the prompts ``tokens: [B, S]`` into ``caches`` (in place).
    Returns ``(last-token logits [B, 1, V], caches)``.

    The VLM needs ``image_embeds`` and the encoder-decoder ``audio_frames``
    (their cross caches are filled here and read by every decode step);
    without it a ``ValueError`` names the input, where the reference fails
    on the missing stream."""
    for needed, name, given in ((cfg.cross_attn_every, "image_embeds",
                                 image_embeds),
                                (cfg.encdec, "audio_frames", audio_frames)):
        if needed and given is None:
            raise ValueError(f"{cfg.name}: prefill needs {name}= (the "
                             "stream its cross-attention blocks attend to)")
    x = _embed(params, tokens, "prefill")
    cross_kv = _cross_stream(params, cfg, image_embeds, audio_frames)
    x, caches, _ = apply_blocks(params["blocks"], x, cfg, "prefill",
                                caches=caches, cross_kv=cross_kv)
    return _logits(params, cfg, x[:, -1:]), caches


def lm_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
              caches: list):
    """One decode step, ``token: [B, 1]``, against ``caches`` (in place).
    Returns ``(logits [B, 1, V], caches)``."""
    x = _embed(params, token, "decode")
    x, caches, _ = apply_blocks(params["blocks"], x, cfg, "decode",
                                caches=caches)
    return _logits(params, cfg, x), caches


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy has no bf16 of its own
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def lm_params_from_numpy(tree, device=None):
    """A JAX parameter or cache tree, its leaves as numpy arrays (bf16
    leaves as ``ml_dtypes.bfloat16``), as the port's tree on ``device``
    (default ``"cuda"``): dicts and lists keep their keys and order, the
    cache NamedTuples (``KVCache``, ``MlaCache``, ``RwkvState``,
    ``RglruState``) become
    the port's classes of the same name, and every leaf keeps its dtype and
    shape."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            cls = _NAMED[type(node).__name__]
            return cls(**{f: convert(getattr(node, f)) for f in cls._fields})
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        if node is None:
            return None
        return _tensor(node, dev)

    return convert(tree)
