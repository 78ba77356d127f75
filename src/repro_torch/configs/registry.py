"""Architecture registry: ``--arch <id>`` resolution + per-arch shape grid,
the PyTorch port of :mod:`repro.configs.registry`.

``long_500k`` requires sub-quadratic attention; it runs only for the
SSM/hybrid archs (rwkv6, recurrentgemma) and is skipped — with the skip
recorded — for pure full-attention archs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                PREFILL_32K, TRAIN_4K, ModelConfig,
                                ShapeConfig)

_MODULES = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3_2_vision_11b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def shapes_for(cfg: ModelConfig) -> list[tuple[ShapeConfig, str | None]]:
    """All 4 assigned shapes with a skip reason (or None = runnable)."""
    out = []
    for shape in ALL_SHAPES:
        reason = None
        if shape is LONG_500K and not cfg.sub_quadratic:
            reason = ("full-attention arch: 524k-token dense KV decode is "
                      "quadratic-cost; skipped per assignment")
        out.append((shape, reason))
    return out


def grid() -> list[tuple[str, ShapeConfig, str | None]]:
    """The full 40-cell (arch x shape) grid with skip annotations."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, reason in shapes_for(cfg):
            cells.append((arch, shape, reason))
    return cells
