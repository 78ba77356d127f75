"""Delta-RWKV6 decode served through the compile->stream stack, on the
PyTorch / CUDA port (``examples/lm_delta_decode.py`` is its JAX twin).

EdgeDRNN thresholds RNN state streams (Eq. 2) and fetches only the weight
columns the fired deltas touch (Eq. 3).  RWKV6 decode is the same
memory-bound shape: per token, every layer streams its r/k/v projections
([D, D] each) and the decay LoRA for batch-1 matvecs, fed by temporally
smooth token-shift streams.  This example runs a REAL greedy decode
session on the reduced ``rwkv6-1.6b`` recipe:

  embedding -> DeltaStreamEngine.step (delta-RWKV6 stack + head)
            -> argmax -> next token's embedding -> ...

through a compiled program (``compile_delta_program(..., cell="rwkv6")``,
the ``dense`` backend: plain PyTorch matmuls on the device), at a sweep of
thresholds, and prints the engine's Eq. 4/7 session accounting: measured
temporal sparsity, modeled weight traffic, and output drift vs the exact
theta=0 decode.  At theta=0 the delta decode is bitwise identical to the
exact dense decode (tests/test_torch_deltarwkv.py asserts this); above it,
weight traffic falls with the firing rate while the decoded token stream
stays pinned until the threshold gets coarse.

Weights and the embedding are drawn on the CPU from fixed seeds and moved
to the device.

Run:  PYTHONPATH=src python examples/lm_delta_decode_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.rwkv6_1_6b import reduced_delta_recipe
from repro_torch.core.program import compile_delta_program
from repro_torch.core.thresholds import ThresholdPolicy
from repro_torch.kernels.ops import resolve_device
from repro_torch.serve.engine import DeltaStreamEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cuda (default; raises without a card) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)

VOCAB = 48
STEPS = 24

cfg, model, task = reduced_delta_recipe(0, output_size=VOCAB, device=dev)
embed = (torch.randn((VOCAB, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)) * 0.3).to(dev)
prog = compile_delta_program(model, backend="dense", cell="rwkv6",
                             device=dev)


def decode_session(theta, force_toks=None):
    """One engine session: greedy-decode STEPS tokens from token 0.

    ``force_toks`` teacher-forces the input stream (for drift comparison
    at matched inputs — free-running argmax feedback is chaotic for a
    random-init model, so it would measure trajectory divergence, not
    delta-approximation drift).
    """
    eng = DeltaStreamEngine(prog, task,
                            thresholds=ThresholdPolicy(theta, theta),
                            device=dev)
    sid = eng.open_stream()
    tok = 0
    toks, logit_rows = [], []
    for t in range(STEPS):
        logits = eng.step(embed[tok])
        logit_rows.append(logits)
        toks.append(int(torch.argmax(logits)))
        tok = toks[-1] if force_toks is None else force_toks[t]
    session = eng.close_stream(sid)
    return toks, torch.stack(logit_rows), session, eng.report()


ref_toks, ref_logits, _, _ = decode_session(0.0)
print(f"delta-RWKV6 greedy decode ({cfg.name}: D={cfg.d_model}, "
      f"L={cfg.n_layers}, vocab={VOCAB}, {STEPS} steps)")
print(f"{'theta':>8} {'gamma_dx':>9} {'gamma_dh':>9} {'KB/step':>8} "
      f"{'drift':>9} {'tok match':>10}")
for theta_int in (0, 8, 32, 64):
    theta = theta_int / 256.0
    toks, logits, session, rep = decode_session(theta, force_toks=ref_toks)
    drift = float(torch.max(torch.abs(logits - ref_logits)))
    match = sum(a == b for a, b in zip(toks, ref_toks)) / len(ref_toks)
    print(f"{theta:8.3f} {session['gamma_dx']:9.3f} "
          f"{session['gamma_dh']:9.3f} "
          f"{session['mean_weight_bytes_per_step'] / 1024:8.1f} "
          f"{drift:9.4f} {match * 100:9.0f}%")
print("\n=> the engine prices exactly what the deltas fetch: at theta=0 "
      "the session\n   streams the full projection volume and reproduces "
      "the exact decode\n   bit-for-bit (drift 0.0000); raising theta "
      "sheds weight traffic at\n   bounded logits drift (teacher-forced "
      "on the reference tokens).")
