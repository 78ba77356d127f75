"""Decoder-only language models over the block schedule, the PyTorch port
of :mod:`repro.models.lm` for the architectures whose blocks are ported
(dense decoders, RWKV6, RecurrentGemma; :func:`repro_torch.models.blocks.
require_ported` names what is missing for the others).

One init and three entry points: the teacher-forced forward, prefill and
decode, pure functions of the parameters except that prefill and decode
write the caches in place (and return them). :func:`init_lm` and
:func:`init_lm_caches` run on the card unless given ``device="cpu"``.
:func:`lm_params_from_numpy` carries a JAX ``init_lm`` tree (or a cache
tree) across leaf for leaf, so the two packages can run the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import (apply_blocks, init_blocks,
                                       init_caches, require_ported)
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       init_norm)
from repro_torch.models.rglru import RglruState
from repro_torch.models.rwkv import RwkvState

# the cache and state NamedTuples of the JAX package, by name
_NAMED = {cls.__name__: cls for cls in (KVCache, RwkvState, RglruState)}


def lm_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _generator(generator, device: torch.device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"a generator on {generator.device} cannot "
                             f"draw weights for {device}")
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def init_lm(generator, cfg: ModelConfig, device=None) -> dict:
    """Parameters of a decoder-only arch, drawn on ``device`` (default
    ``"cuda"``) from ``generator`` (a ``torch.Generator`` of that device, or
    an int seed). A CUDA generator gives other numbers than a CPU one of the
    same seed."""
    require_ported(cfg)
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
    return params


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embedding"].T
    return x @ params["lm_head"]


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup, a gather (the JAX package's one-hot contraction is
    for a vocab-sharded table on a mesh; the port has no mesh yet)."""
    return params["embedding"][tokens.long()]


def lm_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    """Teacher-forced forward. Returns ``(logits [B, S, V], aux_loss)``."""
    x = _embed(params, tokens)
    x, _, aux = apply_blocks(params["blocks"], x, cfg, "train")
    return _logits(params, cfg, x), aux


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> list:
    """Empty caches for ``batch`` slots of ``max_len`` tokens on ``device``
    (default ``"cuda"``)."""
    require_ported(cfg)
    return init_caches(cfg, batch, max_len, lm_dtype(cfg),
                       resolve_device(device))


def lm_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               caches: list):
    """Process the prompts ``tokens: [B, S]`` into ``caches`` (in place).
    Returns ``(last-token logits [B, 1, V], caches)``."""
    x = _embed(params, tokens)
    x, caches, _ = apply_blocks(params["blocks"], x, cfg, "prefill",
                                caches=caches)
    return _logits(params, cfg, x[:, -1:]), caches


def lm_decode(params: dict, cfg: ModelConfig, token: torch.Tensor,
              caches: list):
    """One decode step, ``token: [B, 1]``, against ``caches`` (in place).
    Returns ``(logits [B, 1, V], caches)``."""
    x = _embed(params, token)
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
    cache NamedTuples (``KVCache``, ``RwkvState``, ``RglruState``) become
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
