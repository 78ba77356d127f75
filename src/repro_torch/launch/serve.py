"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--reduced] [--device cpu]``, the PyTorch port of :mod:`repro.launch.serve`.

Brings up an ``LmEngine`` and a ``ContinuousBatcher`` on one device (the
card by default; ``--device cpu`` runs the plain versions), feeds it seeded
synthetic requests, and reports tokens and throughput. Every arch of the
registry initializes; the VLM and the encoder-decoder then stop at the
first prefill with a ``ValueError`` naming ``image_embeds`` /
``audio_frames``: the batcher passes no modality, as the reference's does
(whose launcher fails there too).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.lm import init_lm
from repro_torch.serve.engine import LmEngine
from repro_torch.serve.scheduler import ContinuousBatcher


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[serve] {cfg.name}: {args.slots} slots, max_len {args.max_len} "
          f"on {dev}")
    params = init_lm(0, cfg, device=dev)
    eng = LmEngine(params, cfg, batch=args.slots, max_len=args.max_len,
                   device=dev)
    cb = ContinuousBatcher(eng)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(4, 12)).tolist()
        cb.submit(prompt, max_new_tokens=args.max_new_tokens)

    done, ticks, t0 = [], 0, time.perf_counter()
    while len(done) < args.requests and ticks < 10_000:
        done += cb.step()
        ticks += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / max(wall, 1e-9):.1f} tok/s, {ticks} ticks)")


if __name__ == "__main__":
    main()
