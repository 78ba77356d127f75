"""Abstract inputs and sharding specs for the dry-run, the PyTorch port of
:mod:`repro.launch.specs`.

Everything here is allocation-free. The model, optimizer and cache
structures are trees of tensors on the ``meta`` device (shapes and dtypes,
no storage), the role the reference's ``jax.eval_shape`` structures play:
nothing is drawn, and no tensor of a 16b or 32b cell materialises. The
sharding functions return a tree of :class:`~repro_torch.dist.sharding.
NamedSharding` (a mesh and a spec) shaped like their input, a tree of
tensors of any device. The launcher places its state and batches with
them (``device_put``); the dry-run sizes each device's share of them
(:func:`per_device_bytes`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.elastic import Mesh
from repro_torch.dist.sharding import (P, AxisRules, NamedSharding,
                                       _axis_extent, _map_with_path,
                                       enforce_divisibility,
                                       infer_param_specs)
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import init_caches, make_schedule
from repro_torch.models.lm import init_lm_abstract, lm_dtype
from repro_torch.models.mla import MlaCache
from repro_torch.models.rglru import RglruState
from repro_torch.models.rwkv import RwkvState
from repro_torch.train.optim import init_adam_state, tree_map
from repro_torch.train.trainer import TrainState

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Abstract structures (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> dict:
    return init_lm_abstract(cfg)


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    params = abstract_params(cfg)
    return TrainState(params=params, opt=init_adam_state(params))


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> list:
    return init_caches(cfg, batch, max_len, lm_dtype(cfg), META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta stand-ins for the step's *data* inputs.

    train and prefill: the global batch dict (tokens, and the image
    embeddings or audio frames of the VLM and the encoder-decoder).
    decode: one token per slot (the cache comes from
    :func:`abstract_caches`)."""
    dt = lm_dtype(cfg)
    b, s = shape.global_batch, shape.seq_len

    def sds(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        out = {"tokens": sds((b, s), torch.int32)}
        if cfg.cross_attn_every:
            out["image_embeds"] = sds(
                (b, cfg.n_image_tokens, cfg.vision_dim or cfg.d_model), dt)
        if cfg.encdec:
            out["audio_frames"] = sds((b, cfg.n_audio_frames,
                                       cfg.audio_dim or 80), dt)
        return out
    if shape.kind == "decode":
        return {"token": sds((b, 1), torch.int32)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

def batch_sharding(batch, mesh: Mesh, rules: AxisRules):
    """Each leaf's batch dim on the ``batch`` axes where they divide it,
    the rest replicated."""
    def one(x):
        spec = rules.resolve(*(["batch"] + [None] * (x.ndim - 1)), mesh=mesh)
        spec = enforce_divisibility(spec, x.shape, mesh)
        return NamedSharding(mesh, spec)
    return tree_map(one, batch)


def param_sharding(params, mesh: Mesh, rules: AxisRules):
    specs = infer_param_specs(params, rules=rules, mesh=mesh)
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def train_state_sharding(state: TrainState, mesh: Mesh, rules: AxisRules,
                         opt_rules: AxisRules | None = None) -> TrainState:
    """``opt_rules`` lets the optimizer state shard differently from the
    parameters (ZeRO-1: params data-replicated, mu/nu data-sharded)."""
    opt_rules = opt_rules or rules
    return TrainState(
        params=param_sharding(state.params, mesh, rules),
        opt={"mu": param_sharding(state.opt["mu"], mesh, opt_rules),
             "nu": param_sharding(state.opt["nu"], mesh, opt_rules),
             "step": NamedSharding(mesh, P())})


def cache_sharding(cfg: ModelConfig, caches, mesh: Mesh, rules: AxisRules):
    """Built by construction (it mirrors ``init_caches``), not by path
    rules.

    KV tensors prefer sharding the kv-head dim on the model axis; when the
    head count does not divide (GQA kv=8 on a 16-way axis) they fall back
    to sharding head_dim: without this a 32k decode cache replicates over
    the model axis and overflows a device's memory. Every spec then
    passes the divisibility filter (batch=1 cells drop the data axis,
    etc.)."""
    def r(*axes):
        return rules.resolve(*axes, mesh=mesh)

    model_extent = 1
    for a in (rules.rules.get("kv_heads") or ()):
        model_extent *= mesh.shape.get(a, 1)

    def kv_spec(c: KVCache) -> KVCache:
        kv_heads = c.k.shape[3]
        if model_extent > 1 and kv_heads % model_extent == 0:
            kspec = r(None, "batch", None, "kv_heads", None)
        else:
            kspec = r(None, "batch", None, None, "kv_heads")  # head_dim
        return KVCache(k=kspec, v=kspec, positions=r(None, "batch", None),
                       index=r(None, "batch"))

    def spec_for(kind: str, cache):
        if cache is None:
            return None
        if kind in ("attn", "local_attn"):
            if cfg.use_mla:
                return MlaCache(c_kv=r(None, "batch", None, "kv_lora"),
                                k_rope=r(None, "batch", None, None),
                                index=r(None, "batch"))
            return kv_spec(cache)
        if kind == "cross":
            return {"self": kv_spec(cache["self"]),
                    "ck": r(None, "batch", None, None, "kv_heads"),
                    "cv": r(None, "batch", None, None, "kv_heads")}
        if kind == "rwkv":
            return RwkvState(tm_shift=r(None, "batch", None),
                             cm_shift=r(None, "batch", None),
                             wkv=r(None, "batch", "heads", None, None))
        if kind == "rglru":
            return RglruState(h=r(None, "batch", "ff"),
                              conv=r(None, "batch", None, "ff"))
        raise ValueError(kind)

    out = []
    for (pattern, _), entry in zip(make_schedule(cfg), caches):
        specs_e = {}
        for j, kind in enumerate(pattern):
            cache = entry[f"sub{j}"]
            sp = spec_for(kind, cache)
            if sp is not None:
                sp = _map_with_path(
                    lambda _, s_, c: NamedSharding(
                        mesh, enforce_divisibility(s_, c.shape, mesh)),
                    sp, cache)
            specs_e[f"sub{j}"] = sp
        out.append(specs_e)
    return out


def logits_sharding(mesh: Mesh, rules: AxisRules, batch: int = 0,
                    vocab: int = 0) -> NamedSharding:
    spec = rules.resolve("batch", None, "vocab", mesh=mesh)
    if batch and vocab:
        spec = enforce_divisibility(spec, (batch, 1, vocab), mesh)
    return NamedSharding(mesh, spec)


def per_device_bytes(tree, shardings) -> int:
    """The bytes one device holds of ``tree`` laid out by ``shardings`` (a
    tree of :class:`NamedSharding` shaped like it): each leaf's bytes over
    the extent of its spec's axes (every sharded dim divides, so each
    device holds the same share)."""
    total = [0]

    def one(_, x, sh):
        ext = math.prod(_axis_extent(sh.mesh, e) for e in sh.spec)
        total[0] += x.numel() * x.element_size() // ext
    _map_with_path(one, tree, shardings)
    return total[0]
