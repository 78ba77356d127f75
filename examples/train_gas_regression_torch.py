"""End to end: the paper's SensorsGas regression, full pipeline, on
the PyTorch / CUDA port (``examples/train_gas_regression.py`` is its JAX
twin).

Reproduces the paper's 2-step recipe (Sec. IV-A2) at example scale:
  1. pretrain a dense GRU (the paper's cuDNN-GRU stage),
  2. retrain as a DeltaGRU with dual thresholds (theta_x=4, theta_h=8 in
     Q8.8 — the paper's optimal point) and EdgeDRNN QAT (INT8 weights,
     INT16 activations, Q1.4 LUT nonlinearities),
  3. evaluate RMSE / R^2 and temporal sparsity, and price the deployment
     with Eq. 7 — including checkpointing so the run is resumable.

Training runs eagerly through autograd (no hand-written kernel has a
backward). Weights and batches are drawn on the CPU from fixed seeds and
moved to the device.

Run:  PYTHONPATH=src python examples/train_gas_regression_torch.py \\
          [--steps N] [--hidden H] [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.core.perf_model import EDGEDRNN, estimate_stack
from repro_torch.core.sparsity import GruDims
from repro_torch.data.synthetic import batch_stream, gas_batch
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.gru_rnn import GruTaskConfig, gru_model_forward, \
    init_gru_model
from repro_torch.quant.qat import EDGEDRNN_QAT
from repro_torch.train.losses import r_squared
from repro_torch.train.optim import AdamConfig, constant_schedule
from repro_torch.train.trainer import (LoopHooks, init_train_state,
                                       make_gru_train_step, train_loop)

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=150)
ap.add_argument("--hidden", type=int, default=64)
ap.add_argument("--device", default=None,
                help="cuda (default; raises without a card) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)

H, L = args.hidden, 2
print(f"== SensorsGas regression, 2L-{H}H ==")

# -- stage 1: dense pretrain ------------------------------------------------
dense_task = GruTaskConfig(14, H, L, 1, task="regression")
params = init_gru_model(0, dense_task, device=dev)
step = make_gru_train_step(dense_task,
                           AdamConfig(schedule=constant_schedule(3e-3)),
                           use_delta=False)
state = init_train_state(params)
stream = batch_stream(gas_batch, 1, batch=16, t_len=96, device=dev)
state, hist = train_loop(step, state, stream, args.steps)
print(f"stage 1 (dense pretrain):   loss {hist[0]['loss']:.3f} -> "
      f"{hist[-1]['loss']:.4f}")

# -- stage 2: DeltaGRU retrain with dual thresholds + QAT --------------------
delta_task = GruTaskConfig(14, H, L, 1, task="regression",
                           theta_x=4 / 256, theta_h=8 / 256)
step2 = make_gru_train_step(delta_task,
                            AdamConfig(schedule=constant_schedule(1e-3)),
                            use_delta=True, qat=EDGEDRNN_QAT)
state2 = init_train_state(state.params)
ckpt_dir = tempfile.mkdtemp(prefix="gas_ckpt_")
mgr = CheckpointManager(ckpt_dir, every=50, keep=2)
hooks = LoopHooks(checkpoint_every=50,
                  save_checkpoint=lambda s, st: mgr.maybe_save(s, st))
stream2 = batch_stream(gas_batch, 2, batch=16, t_len=96, device=dev)
state2, hist2 = train_loop(step2, state2, stream2, args.steps // 2,
                           hooks=hooks)
mgr.wait()
print(f"stage 2 (DeltaGRU retrain): loss -> {hist2[-1]['loss']:.4f} "
      f"(checkpoints in {ckpt_dir})")

# -- evaluate ---------------------------------------------------------------
test = gas_batch(9, batch=16, t_len=128, device=dev)
with torch.no_grad():
    out, stats = gru_model_forward(state2.params, delta_task,
                                   test["features"], qat=EDGEDRNN_QAT,
                                   collect_sparsity=True)
rmse = float(torch.sqrt(torch.mean((out - test["targets"]) ** 2)))
r2 = float(r_squared(out, test["targets"]))
gdx, gdh = float(stats["gamma_dx"]), float(stats["gamma_dh"])
print(f"\neval: RMSE={rmse:.3f}  R^2={r2:.3f}   "
      f"(paper's 2L-256H: RMSE 1.078, R^2 0.972)")
print(f"temporal sparsity: gamma_dx={gdx:.3f} gamma_dh={gdh:.3f}   "
      f"(paper optimum: 0.597 / 0.692)")

est = estimate_stack(GruDims(14, H, L), gdx, gdh, EDGEDRNN)
print(f"Eq.7 deployment estimate: {est.latency_s * 1e6:.1f} us/step, "
      f"{est.throughput_ops / 1e9:.2f} GOp/s effective "
      f"(paper's 2L-256H optimum: 206 us)")
