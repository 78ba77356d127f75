"""Synthetic LM token streams and modality stubs for the registry's archs,
the PyTorch port of :mod:`repro.data.lm_data`.

Tokens follow a Zipf-like unigram (alpha ~ 1.1, by the inverse CDF of a
uniform draw) mixed with injected repeated tokens, so the stream is
compressible (the loss curves are not degenerate) and deterministic per
seed. The modality stubs emit the precomputed embeddings the frontends
would produce (the frontends are stubs, as in the reference).

Each batch is its random draws (:func:`token_draws`, from a
``torch.Generator`` on the CPU) and a deterministic build from them
(:func:`token_build`, on ``device``). ``jax.random`` streams cannot be
matched bit for bit, so the split lets a test feed the JAX function's own
draws into the build, as :mod:`repro_torch.data.synthetic` does. Drawing
on the CPU also makes a seed give the same batch on the card and on the
CPU.

Seeds: a ``torch.Generator``, an int, or a tuple of ints (mixed into one
64-bit seed by ``numpy.random.SeedSequence``). :func:`lm_batch_stream`
seeded with ``(..., s)`` yields the batch seeded ``(..., s + i)`` at step
``i``, so a stream seeded ``(1, start)`` continues the one seeded ``(1,
0)`` from its step ``start``: a resumed run reads the batches the
uninterrupted run would have read. (The reference's
``fold_in(fold_in(key, start), i)`` gives a resumed run other batches.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import _generator as _seeded
from repro_torch.kernels.ops import resolve_device

ZIPF_ALPHA = 1.1
REPEAT_P = 0.3          # share of positions that take an injected token
U_MIN = 1e-6            # the uniform draw's lower end (the rank's cap)


def _generator(seed) -> torch.Generator:
    if isinstance(seed, (tuple, list)):
        words = np.random.SeedSequence([int(s) for s in seed]).generate_state(
            2, np.uint32)
        seed = int(words[0]) | (int(words[1]) << 32)
    return _seeded(seed)


def token_draws(generator, batch: int, seq: int, vocab: int) -> dict:
    """The random part of :func:`token_batch`, on the CPU: ``u [B, S]``
    uniform in ``[1e-6, 1)`` (fp32), ``rep [B, S]`` uniform integers in
    ``[0, vocab // 64 + 2)`` and ``use_rep [B, S]`` true with probability
    0.3."""
    g = _generator(generator)
    u = torch.rand((batch, seq), generator=g) * (1.0 - U_MIN) + U_MIN
    rep = torch.randint(0, vocab // 64 + 2, (batch, seq), generator=g,
                        dtype=torch.int32)
    use_rep = torch.rand((batch, seq), generator=g) < REPEAT_P
    return {"u": u, "rep": rep, "use_rep": use_rep}


def token_build(u: torch.Tensor, rep: torch.Tensor, use_rep: torch.Tensor,
                vocab: int, device=None) -> torch.Tensor:
    """The tokens ``[B, S]`` (int32) from their draws, on ``device``
    (default ``"cuda"``; raises without a card unless ``device="cpu"``):
    the Zipf rank ``clip(u ** (-1/1.1), 1, vocab) - 1`` truncated to int32,
    replaced by ``rep`` where ``use_rep``."""
    dev = resolve_device(device)
    u = u.to(dev, torch.float32)
    ranks = torch.clamp(u ** (-1.0 / ZIPF_ALPHA), 1, vocab) - 1
    return torch.where(use_rep.to(dev), rep.to(dev, torch.int32),
                       ranks.to(torch.int32))


def token_batch(generator, batch: int, seq: int, vocab: int,
                device=None) -> torch.Tensor:
    """Tokens ``[B, S]`` (int32) from a generator or seed, on ``device``."""
    return token_build(**token_draws(generator, batch, seq, vocab),
                       vocab=vocab, device=device)


def lm_batch(generator, cfg: ModelConfig, batch: int, seq: int,
             dtype=torch.float32, device=None) -> dict:
    """The batch dict of any registry arch on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``):
    ``tokens [B, S]``, and ``image_embeds [B, n_image_tokens, vision_dim
    or d_model]`` (normal × 0.02) for the VLM, ``audio_frames [B,
    n_audio_frames, audio_dim or 80]`` (standard normal) for the
    encoder-decoder, in ``dtype``. One generator draws the tokens, then
    the modality stub."""
    dev = resolve_device(device)
    g = _generator(generator)
    out = {"tokens": token_batch(g, batch, seq, cfg.vocab, dev)}
    if cfg.cross_attn_every:
        shape = (batch, cfg.n_image_tokens, cfg.vision_dim or cfg.d_model)
        out["image_embeds"] = (torch.randn(shape, generator=g)
                               * 0.02).to(dev, dtype)
    if cfg.encdec:
        shape = (batch, cfg.n_audio_frames, cfg.audio_dim or 80)
        out["audio_frames"] = torch.randn(shape, generator=g).to(dev, dtype)
    return out


def lm_batch_stream(seed, cfg: ModelConfig, batch: int, seq: int,
                    dtype=torch.float32, device=None):
    """Infinite stream of :func:`lm_batch`\\ es: with ``seed`` a tuple of
    ints (an int ``s`` is ``(s,)``), step ``i`` is seeded with ``i`` added
    to its last entry (the module docstring)."""
    dev = resolve_device(device)
    seed = tuple(seed) if isinstance(seed, (tuple, list)) else (int(seed),)
    i = 0
    while True:
        yield lm_batch(seed[:-1] + (seed[-1] + i,), cfg, batch, seq, dtype,
                       dev)
        i += 1
