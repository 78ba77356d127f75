"""Plain PyTorch oracles that are not a kernel's plain version, the part of
:mod:`repro.kernels.ref` that each kernel module does not already hold
(``delta_spmv_ref``, ``deltagru_act_ref``, ``rwkv6_scan_*ref`` and
``rglru_scan_*ref`` live beside their kernels).

* :func:`block_fire_mask` — which ``block_k`` column blocks a delta tile
  fired (the Delta Unit's view of one step).
* :func:`rwkv6_chunked_ref` — chunk-parallel WKV6 in matmul form.
* :func:`rglru_assoc_ref` — the RG-LRU as a log-depth associative scan.

The last two compute the same functions as the sequential scans with
O(chunk) or O(log T) passes instead of T; they run on any device in plain
PyTorch and are differentiable.
"""
from __future__ import annotations

import torch


def block_fire_mask(dx: torch.Tensor, block_k: int = 128) -> torch.Tensor:
    """``[num_blocks]`` bool: does any element of k-block ``j`` fire in any
    row of ``dx: [B, I]``?"""
    b = dx.shape[0]
    d = torch.nn.functional.pad(dx, (0, (-dx.shape[1]) % block_k))
    return torch.any((d.reshape(b, -1, block_k) != 0), dim=2).any(dim=0)


def rwkv6_chunked_ref(r, k, v, w, u, s0=None, chunk: int = 16):
    """Chunk-parallel WKV6, equal in exact arithmetic to the sequential
    scan. Within a chunk of ``C`` steps the recurrence becomes a masked
    ``[C, C]`` score contraction plus two products with the carried state;
    the state crosses chunk boundaries only. With ``La_t = sum_{tau<=t} log
    w_tau`` (per key dim) every exponential taken is ``exp(La_a - La_b)``
    with ``a >= b``, so nothing overflows.

    Shapes: ``r, k, v, w: [B, H, T, D]``, ``u: [H, D]``; returns ``(y:
    [B, H, T, D], s_T: [B, H, D, D])``. T must be a multiple of ``chunk``
    (:func:`repro_torch.kernels.ops.rwkv6_chunked` pads with w = 1, k = 0).
    """
    b, h, t, d = r.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    n = t // chunk
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)

    def chunk_shape(x):
        return x.reshape(b, h, n, chunk, d).to(torch.float32)

    rc, kc, vc, wc = map(chunk_shape, (r, k, v, w))
    la = torch.cumsum(torch.log(torch.clamp_min(wc, 1e-38)), dim=3)
    la_prev = torch.nn.functional.pad(la, (0, 0, 1, 0))[..., :chunk, :]

    # intra-chunk: scores[t, j] = sum_d r_t k_j exp(La_{t-1} - La_j), j < t
    expdiff = torch.exp(la_prev[..., :, None, :] - la[..., None, :, :])
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.einsum("bhntd,bhnjd,bhntjd->bhntj", rc, kc,
                          torch.where(mask[..., None], expdiff, 0.0))
    y_intra = torch.einsum("bhntj,bhnjd->bhntd", scores, vc)
    # diagonal bonus: y_t += (r_t . (u * k_t)) v_t
    y_bonus = torch.sum(rc * u[None, :, None, None, :] * kc, -1,
                        keepdim=True) * vc

    # cross-chunk: a loop over chunks carrying S
    r_tilde = rc * torch.exp(la_prev)
    k_out = kc * torch.exp(la[..., -1:, :] - la)      # decay to chunk end
    a_end = torch.exp(la[..., -1, :])                  # [B, H, N, D]
    s = s0.to(torch.float32)
    y_cross = []
    for c in range(n):
        y_cross.append(torch.einsum("bhtd,bhdv->bhtv", r_tilde[:, :, c], s))
        s = a_end[:, :, c, :, None] * s + torch.einsum(
            "bhtd,bhtv->bhdv", k_out[:, :, c], vc[:, :, c])
    y = y_intra + y_bonus + torch.stack(y_cross, dim=2)
    return y.reshape(b, h, t, d).to(r.dtype), s


def rglru_assoc_ref(x, a, h0=None):
    """The RG-LRU ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t`` as an
    associative scan over ``x, a: [B, T, D]``: the recurrence is associative
    under ``(a1, b1) x (a2, b2) = (a1 a2, a2 b1 + b2)``, so ``ceil(log2 T)``
    full-tensor passes (Hillis-Steele) replace T steps. Decay products stay
    in (0, 1). Returns ``(h: [B, T, D], h_T)``."""
    bt = torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0)) * x
    if h0 is not None:
        # fold h0 in as the contribution of a virtual step before t = 0
        bt = torch.cat([bt[:, :1] + a[:, :1] * h0[:, None], bt[:, 1:]], 1)
    acc_a, acc_b = a, bt
    step = 1
    while step < x.shape[1]:
        acc_a, acc_b = (
            torch.cat([acc_a[:, :step], acc_a[:, :-step] * acc_a[:, step:]],
                      1),
            torch.cat([acc_b[:, :step],
                       acc_a[:, step:] * acc_b[:, :-step] + acc_b[:, step:]],
                      1))
        step *= 2
    return acc_b, acc_b[:, -1]
