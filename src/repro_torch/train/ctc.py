"""Connectionist Temporal Classification loss (Graves et al. 2006), the
PyTorch port of :mod:`repro.train.ctc`.

The paper trains the TIDIGITS networks with CTC (Sec. IV-A). The loss is
the log-space alpha recursion over the blank-interleaved label sequence, a
Python loop over time (the JAX package's ``lax.scan``), for padded batches
with per-example input and label lengths. It keeps the JAX function's
contract, which ``torch.nn.functional.ctc_loss`` does not share: log zero
is the finite ``LOG_EPS``, an empty label scores the all-blank path, and
alpha stays frozen past an example's input length.
"""
from __future__ import annotations

import torch

LOG_EPS = -1e30


def _logaddexp3(a, b, c):
    return torch.logaddexp(torch.logaddexp(a, b), c)


def _shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``x`` shifted ``k`` places along its last axis, ``fill`` entering on
    the left (``jnp.pad(x, ((0, 0), (k, 0)))[:, :S]``)."""
    pad = torch.full((*x.shape[:-1], k), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x], dim=-1)[..., :x.shape[-1]]


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Negative log likelihood per batch element.

    Args:
      log_probs: ``[T, B, C]`` log-softmax outputs.
      labels: ``[B, L]`` int labels (no blanks), padded arbitrarily.
      input_lengths: ``[B]`` valid timesteps.
      label_lengths: ``[B]`` valid label counts.
      blank: blank class index.

    Returns ``[B]`` losses.
    """
    t_max, b, _ = log_probs.shape
    l_max = labels.shape[1]
    s = 2 * l_max + 1  # extended (blank-interleaved) length
    dev = log_probs.device
    labels = labels.long()

    # extended label sequence: blank, l1, blank, l2, ..., blank
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    # can we skip from s-2 to s? only if ext[s] is a label and differs from
    # the label two back
    can_skip = torch.zeros((b, s), dtype=torch.bool, device=dev)
    can_skip[:, 1::2] = labels != _shift_right(labels, 1, -1)

    lp0 = log_probs[0]
    first = torch.gather(lp0, 1, ext[:, 0:1])
    second = torch.where(label_lengths[:, None] > 0,
                         torch.gather(lp0, 1, ext[:, 1:2]), LOG_EPS)
    rest = torch.full((b, max(s - 2, 0)), LOG_EPS, dtype=log_probs.dtype,
                      device=dev)
    alpha = torch.cat([first, second, rest], dim=1)

    running = input_lengths[:, None]
    for t in range(1, t_max):
        prev = _shift_right(alpha, 1, LOG_EPS)
        prev2 = torch.where(can_skip, _shift_right(alpha, 2, LOG_EPS),
                            LOG_EPS)
        new = (_logaddexp3(alpha, prev, prev2)
               + torch.gather(log_probs[t], 1, ext))
        # freeze alpha past each example's input length
        alpha = torch.where(t < running, new, alpha)

    # final: alpha at positions S-1 (last blank) and S-2 (last label),
    # where S = 2*label_length + 1 per example.
    send = 2 * label_lengths.long()  # index of last blank
    idx1 = torch.clamp(send, 0, s - 1)
    idx2 = torch.clamp(send - 1, 0, s - 1)
    a1 = torch.gather(alpha, 1, idx1[:, None])[:, 0]
    a2 = torch.gather(alpha, 1, idx2[:, None])[:, 0]
    a2 = torch.where(label_lengths > 0, a2, LOG_EPS)
    return -torch.logaddexp(a1, a2)


def ctc_greedy_decode(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """Greedy (best-path) decoding: argmax, collapse repeats, drop blanks.

    Returns ``[B, T]`` int64 padded with -1.
    """
    t_max, b, _ = log_probs.shape
    best = torch.argmax(log_probs, dim=-1).T             # [B, T]
    prev = _shift_right(best, 1, blank)
    tpos = torch.arange(t_max, device=best.device)[None]
    keep = ((best != blank) & (best != prev)
            & (tpos < input_lengths[:, None]))
    pos = torch.cumsum(keep, dim=1) - 1
    # dropped symbols all land in one extra column, cut off below
    out = torch.full((b, t_max + 1), -1, dtype=best.dtype,
                     device=best.device)
    out.scatter_(1, torch.where(keep, pos, t_max), best)
    return out[:, :t_max]


def edit_distance(a, b) -> int:
    """Levenshtein distance between two label lists (host-side, for WER)."""
    la, lb = len(a), len(b)
    dp = list(range(lb + 1))
    for i in range(1, la + 1):
        prev, dp[0] = dp[0], i
        for j in range(1, lb + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                        prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[lb]
