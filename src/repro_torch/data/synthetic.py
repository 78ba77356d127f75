"""Synthetic stand-ins for the paper's datasets, the PyTorch port of
:mod:`repro.data.synthetic`.

Nothing is downloaded; the generators synthesize data with the statistical
properties that matter to the paper's claims:

* ``digits``: TIDIGITS-like spoken-digit sequences. Each digit class is a
  smooth formant trajectory in a 40-dim filter-bank space; sequences carry
  1..7 digits with silences. Temporally smooth, so deltas are sparse;
  CTC-trainable.
* ``gas``: SensorsGas-like regression. A slow latent CO concentration
  (Ornstein-Uhlenbeck) drives 14 metal-oxide-like sensors through
  per-sensor power-law responses, baseline drift and noise.

Each generator is its random draws (``digit_draws`` / ``gas_draws``, from a
``torch.Generator`` on the CPU) and a deterministic build from them
(``digit_build`` / ``gas_build``, on ``device``). ``jax.random`` streams
cannot be matched bit for bit, so the split lets a test feed the JAX
function's own draws into the build.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ops import resolve_device

N_DIGIT_CLASSES = 11   # 'oh', zero..nine
N_FEATS = 40
N_SENSORS = 14


def _generator(generator) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


# ---------------------------------------------------------------------------
# TIDIGITS-like
# ---------------------------------------------------------------------------

def _digit_template(digit: torch.Tensor, t_frac: torch.Tensor) -> torch.Tensor:
    """[.., N_FEATS] formant pattern for a digit at relative time t_frac."""
    mel = torch.arange(N_FEATS, dtype=torch.float32, device=t_frac.device)
    # two "formants" whose center and slope depend on the digit id
    c1 = 4.0 + 2.5 * (digit % 4).to(torch.float32) + 6.0 * t_frac
    c2 = (18.0 + 1.7 * (digit % 7).to(torch.float32) - 4.0 * t_frac
          + 3.0 * torch.sin(2 * math.pi * t_frac
                            * (1 + (digit % 3).to(torch.float32))))
    w1 = (1.5 + 0.3 * (digit % 2).to(torch.float32))[..., None]

    def bump(c, w):
        return torch.exp(-0.5 * torch.square((mel - c[..., None]) / w))
    return 2.0 * bump(c1, w1) + 1.5 * bump(c2, 2.0)


def digit_draws(generator, batch: int = 32, max_t: int = 96,
                max_l: int = 7) -> dict:
    """The random part of :func:`digit_batch`, on the CPU: label counts
    ``lab_lens [B]`` in 1..max_l, ``labels [B, L]`` in 0..10, digit
    durations ``dur [B, L]`` in 8..12 frames, standard-normal ``noise
    [B, T, F]`` and ``floor [B, 1, F]``."""
    g = _generator(generator)
    return {
        "lab_lens": torch.randint(1, max_l + 1, (batch,), generator=g),
        "labels": torch.randint(0, N_DIGIT_CLASSES, (batch, max_l),
                                generator=g),
        "dur": torch.randint(8, 13, (batch, max_l), generator=g),
        "noise": torch.randn((batch, max_t, N_FEATS), generator=g),
        "floor": torch.randn((batch, 1, N_FEATS), generator=g),
    }


def digit_build(draws: dict, device=None) -> dict:
    """The batch from its draws, on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``): dict(features [T,B,40],
    labels [B,L] (1..11, 0 is the CTC blank), in_lens, lab_lens)."""
    dev = resolve_device(device)
    d = {k: v.to(dev) for k, v in draws.items()}
    batch, max_t, _ = d["noise"].shape
    max_l = d["labels"].shape[1]
    lab_lens, labels = d["lab_lens"], d["labels"]
    gap = 2  # silence frames after each digit
    active = (torch.arange(max_l, device=dev)[None] < lab_lens[:, None]).long()
    dur = d["dur"] * active
    starts = torch.cumsum(dur + gap * active, dim=1) - dur
    in_lens = torch.clamp(torch.sum(dur + gap * active, dim=1) + 4, 0, max_t)

    tpos = torch.arange(max_t, dtype=torch.float32, device=dev)
    # [B, T, L]: relative position of t within each digit segment
    rel = ((tpos[None, :, None] - starts[:, None, :])
           / torch.clamp(dur[:, None, :], min=1))
    inside = (rel >= 0) & (rel < 1) & (dur[:, None, :] > 0)
    tpl = _digit_template(labels[:, None, :], torch.clamp(rel, 0, 1))
    feats = torch.sum(tpl * inside[..., None], dim=2)          # [B, T, F]
    feats = feats + 0.08 * d["noise"] + 0.1 * d["floor"]
    return {"features": feats.transpose(0, 1).contiguous(),   # [T, B, F]
            "labels": (labels + 1).to(torch.int32),          # 0 = blank
            "in_lens": in_lens.to(torch.int32),
            "lab_lens": lab_lens.to(torch.int32)}


def digit_batch(generator, batch: int = 32, max_t: int = 96, max_l: int = 7,
                device=None) -> dict:
    """A TIDIGITS-like CTC batch from a ``torch.Generator`` (or an int
    seed): dict(features [T,B,40], labels [B,L], in_lens, lab_lens) on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``)."""
    return digit_build(digit_draws(generator, batch, max_t, max_l), device)


# ---------------------------------------------------------------------------
# SensorsGas-like
# ---------------------------------------------------------------------------

def gas_draws(generator, batch: int = 16, t_len: int = 256) -> dict:
    """The random part of :func:`gas_batch`, on the CPU: standard-normal
    OU innovations ``eps [T, B]`` and start ``c0 [B]``, uniform sensor gains
    ``a [14]`` and exponents ``p [14]``, standard-normal drift steps
    ``drift [T, B, 14]`` and ``noise [T, B, 14]``."""
    g = _generator(generator)
    return {
        "eps": torch.randn((t_len, batch), generator=g),
        "c0": torch.randn((batch,), generator=g),
        "a": torch.rand((N_SENSORS,), generator=g),
        "p": torch.rand((N_SENSORS,), generator=g),
        "drift": torch.randn((t_len, batch, N_SENSORS), generator=g),
        "noise": torch.randn((t_len, batch, N_SENSORS), generator=g),
    }


def gas_build(draws: dict, device=None) -> dict:
    """The batch from its draws, on ``device`` (as :func:`digit_build`):
    dict(features [T,B,14], targets [T,B,1])."""
    dev = resolve_device(device)
    d = {k: v.to(dev) for k, v in draws.items()}
    # latent concentration: OU process, slow (tau ~ 40 steps)
    c = 2.0 + d["c0"] * 0.5
    conc = []
    for e in d["eps"]:
        c = c + 0.025 * (2.0 - c) + 0.15 * e
        conc.append(c)
    conc = torch.abs(torch.stack(conc))                      # [T, B]
    # per-sensor response: r_i = a_i * c^p_i + drift + noise
    a = 0.5 + d["a"]
    p = 0.4 + 0.5 * d["p"]
    drift = 0.05 * torch.cumsum(d["drift"] * 0.02, dim=0)
    resp = a * torch.pow(conc[..., None] + 1e-3, p) + drift
    resp = resp + 0.02 * d["noise"]
    return {"features": resp.to(torch.float32),
            "targets": conc[..., None].to(torch.float32)}


def gas_batch(generator, batch: int = 16, t_len: int = 256,
              device=None) -> dict:
    """A SensorsGas-like regression batch from a ``torch.Generator`` (or an
    int seed): dict(features [T,B,14], targets [T,B,1]) on ``device``
    (default ``"cuda"``; raises without a card unless ``device="cpu"``)."""
    return gas_build(gas_draws(generator, batch, t_len), device)


def batch_stream(gen, generator, **kw):
    """Infinite generator of batches ``gen(g, **kw)``, each drawn next from
    one ``torch.Generator`` (or one seeded from an int)."""
    g = _generator(generator)
    while True:
        yield gen(g, **kw)
