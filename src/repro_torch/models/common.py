"""Shared model components: initializers, norms, RoPE, activations, the
PyTorch port of :mod:`repro.models.common`.

Everything is functional: ``init_*`` builds parameter trees (plain dicts of
tensors), the ``apply``-style functions are pure. The compute dtype follows
the parameters; norm statistics (and the attention softmax) run in float32
and the result is cast back to the input's dtype.

The initializers draw from the ``torch.Generator`` they are given, on that
generator's device: a CUDA generator draws on the card, so a full-size model
is made where it runs. The draws are not JAX's; parity tests carry the JAX
package's weights across (:func:`repro_torch.models.lm.lm_params_from_numpy`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.ranks import psum_disjoint

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (at ±2σ) fan-in init, drawn in fp32 on the
    generator's device."""
    std = scale if scale is not None else in_dim ** -0.5
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """``N(0, 0.02²)`` embedding table, drawn in fp32 on the generator's
    device."""
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# The row-parallel product of the split over ranks
# ---------------------------------------------------------------------------

class _WideProduct(torch.autograd.Function):
    """``h @ w`` of bf16 or fp16 operands with its fp32 accumulation
    returned unrounded (cuBLAS's ``mm`` with ``out_dtype``; on the CPU the
    product of the operands widened to fp32). The backward is the
    narrow product's: the incoming gradient in the operands' dtype, then
    ``g @ w.T`` and ``h.T @ g``, as autograd differentiates ``h @ w``."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        rows = h.reshape(-1, h.shape[-1])
        y = (torch.mm(rows, w, out_dtype=torch.float32) if h.is_cuda
             else rows.float() @ w.float())
        return y.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        gw = h.reshape(-1, h.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ w.T, gw


def row_parallel(h: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """``h @ w``; ``tp`` (a ``sharding.TpGroup``): ``h`` and ``w`` are the
    rank's columns and rows of a product that the group splits along its
    contraction, and the parts are summed over the group
    (``ranks.psum_disjoint``). In bf16 or fp16 each part stays in fp32
    until the sum, which is rounded once to the operands' dtype, as one
    process rounds the whole product (GSPMD rounds each part first: the
    split step then lies further from one process's, ``ROADMAP.md``
    R44)."""
    if tp is None:
        return h @ w
    if h.dtype in (torch.bfloat16, torch.float16):
        return psum_disjoint(_WideProduct.apply(h, w), tp.group).to(h.dtype)
    return psum_disjoint(h @ w, tp.group)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, elementwise: bool = True,
                   device=None) -> dict:
    if not elementwise:  # OLMo's non-parametric LayerNorm
        return {}
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in fp32 with the population variance (``jnp.var``)."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if "scale" in params:
        y = (y * params["scale"].to(torch.float32)
             + params["bias"].to(torch.float32))
    return y.to(x.dtype)


def init_norm(kind: str, dim: int, dtype=torch.float32, device=None) -> dict:
    if kind == "rmsnorm":
        return init_rmsnorm(dim, dtype, device)
    if kind == "layernorm":
        return init_layernorm(dim, dtype, device=device)
    if kind == "layernorm_np":  # non-parametric (OLMo)
        return init_layernorm(dim, dtype, elementwise=False, device=device)
    raise ValueError(f"unknown norm kind {kind!r}")


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(params, x)
    return layernorm(params, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x: [..., S, H, D]`` by ``positions: [..., S]`` (int), the
    two halves of the head (not interleaved pairs), in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [D/2]
    angles = positions[..., :, None].to(torch.float32) * freqs  # [..., S, D/2]
    angles = angles[..., :, None, :]                            # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# jax.nn.gelu's default is the tanh approximation: "gelu" and "gelu_tanh"
# are the same function
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "gelu_tanh": _gelu_tanh,
    "relu": F.relu,
    "relu_sq": lambda x: torch.square(F.relu(x)),
    "tanh": torch.tanh,
}


def tree_map(fn, tree, *rest):
    """``fn`` over the matching tensor leaves of parameter or cache trees
    (dicts, lists, tuples, NamedTuples; ``None`` stays ``None``), the port's
    ``jax.tree_util.tree_map``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a parameter or cache tree (dicts, lists, tuples and
    NamedTuples), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def count_params(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))
