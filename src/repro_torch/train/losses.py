"""Loss functions: LM cross-entropy (with z-loss), regression, the CTC
wrapper; the PyTorch port of :mod:`repro.train.losses`."""
from __future__ import annotations

import torch

from repro_torch.train.ctc import ctc_loss


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          z_loss: float = 0.0):
    """Token-level CE. ``logits: [..., V]``, ``labels: [...]`` int.

    Returns (mean loss, metrics). ``z_loss`` regularizes the partition
    function (stabilizes large-vocab training).
    """
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    # label pick by comparing against the vocabulary index, as the JAX
    # package does (its spelling partitions over a vocab-sharded axis)
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.where(vocab_iota == labels[..., None], logits, 0.0)
    ll = torch.sum(picked, dim=-1)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is None:
        mask = torch.ones_like(loss)
    mask = mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    mean = torch.sum(loss * mask) / denom
    acc = torch.sum((torch.argmax(logits, -1) == labels) * mask) / denom
    return mean, {"ce": mean, "accuracy": acc, "tokens": denom}


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            mask: torch.Tensor | None = None, z_loss: float = 1e-4):
    """Next-token prediction: logits[:, :-1] vs tokens[:, 1:]."""
    m = None if mask is None else mask[:, 1:]
    return softmax_cross_entropy(logits[:, :-1], tokens[:, 1:], m, z_loss)


def mse_loss(pred: torch.Tensor, target: torch.Tensor):
    err = pred.to(torch.float32) - target.to(torch.float32)
    mse = torch.mean(torch.square(err))
    return mse, {"mse": mse, "rmse": torch.sqrt(mse)}


def r_squared(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Coefficient of determination (paper's regression metric)."""
    target = target.to(torch.float32)
    ss_res = torch.sum(torch.square(pred.to(torch.float32) - target))
    ss_tot = torch.sum(torch.square(target - torch.mean(target)))
    return 1.0 - ss_res / (ss_tot + 1e-9)


def ctc_loss_mean(logits: torch.Tensor, labels: torch.Tensor,
                  input_lengths: torch.Tensor, label_lengths: torch.Tensor):
    """``logits: [T, B, C]`` raw (pre-softmax)."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = ctc_loss(log_probs, labels, input_lengths, label_lengths)
    mean = torch.mean(nll / torch.clamp(label_lengths, min=1))
    return mean, {"ctc": mean}
