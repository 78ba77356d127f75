"""Quickstart: the delta-network algorithm in five minutes, on the
PyTorch / CUDA port (``examples/quickstart.py`` is its JAX twin).

1. Build a GRU and its DeltaGRU twin; verify they agree at theta=0.
2. Turn the threshold up; watch temporal sparsity appear and outputs stay
   close.
3. Price the sparsity with the paper's Eq. 7 performance model.
4. Run the block-sparse CUDA kernel ``delta_spmv`` and see the modeled HBM
   weight-traffic drop.
5. Compile once, stream forever: `compile_deltagru` packs the weights into
   an immutable program (fp32 fused or int8 fused_q8) whose states can
   only be built with the right delta-memory convention; each step of it
   is one fused CUDA kernel a layer.
6. The same recipe on the LSTM family: `compile_delta_program(cell="lstm",
   backend="fused_q8")` quantizes the 4-gate stack through the identical
   cell-agnostic int8 core — int8 weight codes, Q8.8 activations, LUT
   gates, saturating Q8.8 cell state.

Weights and inputs are drawn on the CPU from fixed seeds and moved to the
device, so a run on the card and one with ``--device cpu`` (the kernels'
plain PyTorch versions) see the same numbers.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.deltagru import (deltagru_sequence, gru_sequence,
                                       init_gru_stack)
from repro_torch.core.perf_model import EDGEDRNN, estimate_stack
from repro_torch.core.program import compile_deltagru
from repro_torch.core.sparsity import GruDims
from repro_torch.kernels import ops
from repro_torch.kernels.delta_spmv import delta_spmv_hbm_bytes

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cuda (default; raises without a card) or cpu")
args = ap.parse_args()
dev = ops.resolve_device(args.device)
gen = torch.Generator().manual_seed(0)


def to_dev(stack):
    return [type(p)(*(t.to(dev) for t in p)) for p in stack]


# --- 1. a 2-layer GRU on a slowly-varying input stream -------------------
I, H, L, T = 16, 64, 2, 120
params = to_dev(init_gru_stack(gen, I, H, L))
t = torch.arange(T, dtype=torch.float32)[:, None, None]
xs = (0.8 * torch.sin(0.05 * t + torch.arange(I) * 0.4)
      + 0.05 * torch.randn((T, 1, I), generator=gen)).to(dev)

ys_dense = gru_sequence(params, xs)
ys_delta0, _, _ = deltagru_sequence(params, xs, 0.0, 0.0)
print(f"theta=0   max |DeltaGRU - GRU| = "
      f"{float(torch.max(torch.abs(ys_delta0 - ys_dense))):.2e}  (exact)")

# --- 2. thresholds on: sparsity appears, accuracy degrades gracefully ----
for theta_q88 in (8, 32, 64):
    theta = theta_q88 / 256
    ys, _, stats = deltagru_sequence(params, xs, theta, theta)
    err = float(torch.max(torch.abs(ys - ys_dense)))
    print(f"theta={theta_q88:3d} (Q8.8)  gamma_dx={float(stats['gamma_dx']):.2f} "
          f"gamma_dh={float(stats['gamma_dh']):.2f}  max err={err:.3f}")

# --- 3. what that sparsity buys on the accelerator (Eq. 7) ---------------
_, _, stats = deltagru_sequence(params, xs, 0.25, 0.25)
est = estimate_stack(GruDims(I, H, L), float(stats["gamma_dx"]),
                     float(stats["gamma_dh"]), EDGEDRNN)
print(f"\nEq.7 on the EdgeDRNN config (8 PEs @125 MHz, peak 2 GOp/s):")
print(f"  est latency/step = {est.latency_s * 1e6:.1f} us, effective "
      f"throughput = {est.throughput_ops / 1e9:.1f} GOp/s "
      f"({est.throughput_ops / EDGEDRNN.peak_ops:.1f}x peak via sparsity)")

# --- 4. the CUDA kernel: block-column skipping ---------------------------
w = torch.randn((512, 512), generator=gen).to(dev)
dx_dense = torch.randn((1, 512), generator=gen).to(dev)
dx_sparse = dx_dense * (torch.arange(512, device=dev) < 128)  # 1 of 4 fire
y = ops.delta_spmv(w, dx_sparse)
dense_b = float(delta_spmv_hbm_bytes((512, 512), dx_dense))
sparse_b = float(delta_spmv_hbm_bytes((512, 512), dx_sparse))
print(f"\ndelta_spmv kernel: weight HBM traffic {sparse_b / dense_b:.2f}x "
      f"of dense (fired blocks only), result finite: "
      f"{bool(torch.all(torch.isfinite(y)))}")

# --- 5. compile -> stream: the program API -----------------------------
prog = compile_deltagru(params, backend="fused", device=dev)  # packs once
state = prog.init_state(batch_shape=(1,))              # right convention, always
for x in xs[:8]:
    y_t, state, _ = prog.step(state, x, 0.1, 0.1)
ys_prog, _, _ = prog.sequence(xs, 0.1, 0.1)            # or a whole sequence
ys_legacy, _, _ = deltagru_sequence(params, xs, 0.1, 0.1, backend="fused")
print(f"\ncompiled program (backend={prog.backend}): step/sequence API, "
      f"max |program - legacy kwargs| = "
      f"{float(torch.max(torch.abs(ys_prog - ys_legacy))):.1e}")

prog_q8 = compile_deltagru(params, backend="fused_q8", device=dev)
ys_q8, _, st = prog_q8.sequence(xs, 0.1, 0.1)          # quantize = compile
print(f"int8 program: weights quantized+packed at compile time, "
      f"gamma_dh={float(st['gamma_dh']):.2f}, "
      f"max |q8 - fp32| = {float(torch.max(torch.abs(ys_q8 - ys_prog))):.3f}")
try:
    prog_q8.step(state, xs[0], 0.1, 0.1)               # fp32-convention state
except ValueError as e:
    print(f"state safety: {str(e)[:64]}...")

# --- 6. quantized LSTM: the same int8 core, one more gate row ------------
from repro_torch.core.deltalstm import init_lstm_stack
from repro_torch.core.program import compile_delta_program

lstm_params = to_dev(init_lstm_stack(gen, I, H, L))
lprog = compile_delta_program(lstm_params, cell="lstm", backend="fused",
                              device=dev)
lq8 = compile_delta_program(lstm_params, cell="lstm", backend="fused_q8",
                            device=dev)
ys_l, _, _ = lprog.sequence(xs, 0.1, 0.1)
ys_lq8, _, st = lq8.sequence(xs, 0.1, 0.1)
print(f"\nquantized LSTM (cell={lq8.cell}, backend={lq8.backend}): "
      f"int8 [4, Hp, Ip+Hk] codes, gamma_dh={float(st['gamma_dh']):.2f}, "
      f"max |q8 - fp32| = {float(torch.max(torch.abs(ys_lq8 - ys_l))):.3f}")
lay = lq8.layouts[0]
print(f"  layout: gates={lay.gates}, w_q {tuple(lay.w_q.shape)} "
      f"{str(lay.w_q.dtype).replace('torch.', '')} (1 byte/weight vs 4 — "
      "the 0.25x DRAM story on the paper's edge-comparison cell family)")
