"""Batch-1 streaming serving — the paper's deployment mode (Fig. 1), on the
PyTorch / CUDA port (``examples/serve_stream_digits.py`` is its JAX twin).

Trains a small CTC digit recognizer, then streams utterances frame-by-frame
through the GruStreamEngine exactly as EdgeDRNN ingests filter-bank frames:
one vector per step, delta-encoded against the state memory, with live
sparsity accounting, the Eq. 7 latency estimate per frame, and the
closed-loop dynamic-threshold controller (the paper's proposed future work)
holding a latency budget. On the card each engine step is one CUDA-graph
replay of the fused fp32 kernel (``deltagru_seq``), of the int8 kernel
(``delta_q8``) once the model is quantized, and of the int8 kernel's
batched tile under the session batcher.

Weights and batches are drawn on the CPU from fixed seeds and moved to the
device.

Run:  PYTHONPATH=src python examples/serve_stream_digits_torch.py \\
          [--steps N] [--device cpu]
"""
import argparse

import torch

from repro_torch.data.synthetic import batch_stream, digit_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.gru_rnn import GruTaskConfig, init_gru_model
from repro_torch.serve.engine import GruStreamEngine
from repro_torch.train.ctc import ctc_greedy_decode
from repro_torch.train.optim import AdamConfig, constant_schedule
from repro_torch.train.trainer import init_train_state, make_gru_train_step, \
    train_loop

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=400)
ap.add_argument("--device", default=None,
                help="cuda (default; raises without a card) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)

# -- train a small recognizer ------------------------------------------------
task = GruTaskConfig(40, 96, 2, 12, task="ctc",
                     theta_x=8 / 256, theta_h=8 / 256)
params = init_gru_model(0, task, device=dev)
step = make_gru_train_step(task, AdamConfig(schedule=constant_schedule(3e-3)))
state = init_train_state(params)
stream = batch_stream(digit_batch, 1, batch=16, max_t=64, max_l=4,
                      device=dev)
state, hist = train_loop(step, state, stream, args.steps)
print(f"trained digit recognizer: CTC loss {hist[0]['loss']:.2f} -> "
      f"{hist[-1]['loss']:.2f}")

# -- stream one utterance, batch-1, frame by frame ---------------------------
eng = GruStreamEngine(state.params, task, device=dev)
utt = digit_batch(7, batch=1, max_t=96, max_l=4, device=dev)
frames = utt["features"][:, 0]
logits = torch.stack([eng.step(f) for f in frames])     # [T, 12]

lp = torch.log_softmax(logits[:, None], dim=-1)
dec = ctc_greedy_decode(lp, utt["in_lens"][:1])[0].tolist()
hyp = [int(x) - 1 for x in dec if x >= 1]
ref = [int(x) - 1 for x in
       utt["labels"][0][: int(utt["lab_lens"][0])].tolist()]
print(f"reference digits: {ref}")
print(f"decoded digits:   {hyp}")

rep = eng.report()
print(f"\nstreaming report over {rep['steps']} frames:")
print(f"  gamma_dx={rep['gamma_dx']:.3f} gamma_dh={rep['gamma_dh']:.3f}")
print(f"  mean Eq.7 latency {rep['mean_est_latency_us']:.1f} us/frame, "
      f"effective {rep['effective_throughput_gops']:.2f} GOp/s")

# -- quantized deployment: compile to an int8 program, stream it ------------
from repro_torch.quant.export import quantize_gru_model

qprog = quantize_gru_model(state.params, device=dev)  # a fused_q8 program
eng_q = GruStreamEngine(qprog, task, device=dev)
for f in frames:
    eng_q.step(f)
rep_q = eng_q.report()
print(f"\nint8 deployment (backend=fused_q8, {rep_q['weight_bits']}-bit "
      "weights streamed):")
print(f"  gamma_dh={rep_q['gamma_dh']:.3f}, "
      f"{rep_q['mean_weight_bytes_per_step']:.0f} weight bytes/frame, "
      f"latency {rep_q['mean_est_latency_us']:.1f} us/frame")

# -- heavy traffic: many short-lived streams over a few session slots -------
from repro_torch.serve.scheduler import GruStreamBatcher

eng_m = GruStreamEngine(qprog, task, n_streams=4, device=dev)
cb = GruStreamBatcher(eng_m)
for k in range(10):                       # 10 utterances, 4 slots
    u = digit_batch(100 + k, batch=1, max_t=48, max_l=2, device=dev)
    cb.submit(u["features"][:, 0].cpu())
finished = cb.run_until_drained()
mean_lat = sum(r.stats["mean_est_latency_us"] for r in finished) / len(
    finished)
print(f"\nsession batcher: {len(finished)} streams recycled through "
      f"{eng_m.n_streams} slots (one weight fetch per tick serves all); "
      f"mean per-stream latency {mean_lat:.1f} us/frame")

# -- dynamic threshold: hold a firing-rate budget (paper Sec. VI) -----------
eng2 = GruStreamEngine(state.params, task, dynamic_target_fired=0.15,
                       device=dev)
for f in frames:
    eng2.step(f)
rep2 = eng2.report()
print(f"\nwith closed-loop theta controller (target 15% hidden firing):")
print(f"  theta_h adapted {task.theta_h:.4f} -> {rep2['theta_h']:.4f}; "
      f"gamma_dh={rep2['gamma_dh']:.3f}, "
      f"latency {rep2['mean_est_latency_us']:.1f} us/frame")
