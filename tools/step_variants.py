#!/usr/bin/env python3
"""Two design choices of ``DeltaStreamEngine``'s step, each timed both ways
in one process on one NVIDIA GPU, the two sides taking turns.

* ``pdl``: the Delta Unit launched as a programmatic dependent launch, or
  plainly as the port launches it. The dependent variant is built from
  ``csrc/delta_unit.cu`` with the launch attribute and a
  ``griddepcontrol.wait`` before the first read of the operands added;
  every other kernel is the same. Per path (the 2L-768H GRU ``fused_q8``,
  RG-LRU at D = 4096 with 4 layers and RWKV6 at D = 2048 with 24 layers,
  each at one stream): the time a step between two CUDA events around
  ``step_many`` over frames already on the card (its graph replays are
  enqueued back to back, so the events time the device's work), three
  runs an engine, engines in the order A B B A A B.
* ``fold``: the frame guard inside layer 0's Delta Unit, or in plain ops
  before the step (``DeltaStreamEngine.guard_folds`` forced either way),
  on the 2L-768H GRU ``fused_q8``, LSTM ``fused`` and GRU ``fused`` paths
  at N in {1, 8, 32, 64, 128} slots (the frames shifted by 0.01 a slot):
  the CUDA-event time a step of ``step_many`` over 96 frames (three runs
  an engine), and the device-busy time and the Delta Unit's time a step
  (``chip_smoke.engine_profile`` over 48 steps), engines A B B A.

Weights are seeded random, θx = θh = 0.25, frames drawn as
``chip_smoke.py`` draws them. Run from the root of a checkout on a host
with a CUDA card and ``nvcc``: ``python3 tools/step_variants.py [pdl]
[fold]`` (both when none is named). Prints one JSON line per path and slot
count, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLOTS = (1, 8, 32, 64, 128)


def dependent_launch_source(src: str) -> str:
    """``csrc/delta_unit.cu`` as a programmatic dependent launch."""
    wait = ("  __syncthreads();\n\n  const float theta =",
            "  __syncthreads();\n  asm volatile(\"griddepcontrol.wait;\" ::: "
            "\"memory\");\n  const float theta =")
    attr = ("  cfg.stream = (cudaStream_t)stream;\n",
            "  cfg.stream = (cudaStream_t)stream;\n"
            "  cudaLaunchAttribute attr[1];\n"
            "  attr[0].id ="
            " cudaLaunchAttributeProgrammaticStreamSerialization;\n"
            "  attr[0].val.programmaticStreamSerializationAllowed = 1;\n"
            "  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n")
    for old, new in (wait, attr):
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/delta_unit.cu changed: {old!r} not "
                               "found once")
        src = src.replace(old, new)
    return src


def main(argv: list) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.edgedrnn import CONFIG_2L768H as cfg
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RGLRU
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6
    from repro_torch.core.deltarglru import init_deltarglru_model
    from repro_torch.core.deltarwkv import init_deltarwkv_model
    from repro_torch.core.program import compile_delta_program
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_unit import guard_fits
    from repro_torch.models.gru_rnn import (GruTaskConfig, init_gru_model,
                                            init_lstm_model)
    from repro_torch.serve.engine import DeltaStreamEngine
    what = set(argv) or {"pdl", "fold"}
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    _build.build()
    task = GruTaskConfig(cfg.input_size, cfg.hidden_size, cfg.num_layers,
                         cfg.output_size, theta_x=cs.THETA,
                         theta_h=cs.THETA)

    def event_us(eng, frames, runs=3):
        out = []
        for _ in range(runs):
            eng.reset()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.step_many(frames)
            stop.record()
            torch.cuda.synchronize()
            out.append(1e3 * start.elapsed_time(stop) / len(frames))
        return out

    def warm(eng, frames):
        """Every chunk graph captured (31 = 16 + 8 + 4 + 2 + 1 frames)."""
        eng.step_many(frames[:cs.WARM_FRAMES])
        eng.reset()
        torch.cuda.synchronize()
        return eng

    if "pdl" in what:
        src = (_build.CSRC / "delta_unit.cu").read_text()
        lib = _build.BUILD_DIR / "delta_unit-dependent.so"
        var = lib.with_suffix(".cu")
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        var.write_text(dependent_launch_source(src))
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib), str(var)], check=True,
                       capture_output=True)
        libs = {"plain": _build.load("delta_unit.cu"),
                "dependent": ctypes.CDLL(str(lib))}
        rng = np.random.default_rng(cs.SEED)
        frames = cs.smooth_frames(rng, cs.N_FRAMES, 1, cfg.input_size)[:, 0]
        paths = [("gru fused_q8", compile_delta_program(
            init_gru_model(cs.SEED, cfg, device="cuda"), "fused_q8",
            cell="gru"), task, frames)]
        for cell, init, d, layers in (
                ("rglru", init_deltarglru_model, RGLRU.d_model,
                 cs.RGLRU_LAYERS),
                ("rwkv6", init_deltarwkv_model, RWKV6.d_model,
                 RWKV6.n_layers)):
            model = init(cs.SEED, d, layers, cs.LM_OUTPUT, device="cpu")
            prog = compile_delta_program(model, "fused", cell=cell)
            del model
            paths.append((f"{cell} fused", prog,
                          GruTaskConfig(d, d, layers, cs.LM_OUTPUT,
                                        theta_x=cs.THETA, theta_h=cs.THETA),
                          cs.lm_stream(rng, 160, d)))
        for path, prog, tk, fr in paths:
            fr = torch.as_tensor(fr, dtype=torch.float32, device="cuda")
            res = {}
            for side in ("dependent", "plain", "plain", "dependent",
                         "dependent", "plain"):
                _build._LIBS["delta_unit.cu"] = libs[side]
                eng = warm(DeltaStreamEngine(prog, tk), fr)
                res.setdefault(side, []).extend(event_us(eng, fr))
                del eng
            _build._LIBS["delta_unit.cu"] = libs["plain"]
            print(json.dumps({"choice": "delta unit launch", "path": path,
                              "frames": len(fr), "event_us_per_step": res,
                              "card": smi}), flush=True)
            del prog

    if "fold" in what:
        default = DeltaStreamEngine.guard_folds
        forced = {"folded": property(lambda self: True),
                  "plain": property(lambda self: False)}
        rng = np.random.default_rng(cs.SEED + 1)
        frames = cs.smooth_frames(rng, 96, 1, cfg.input_size)[:, 0]
        for cell, init, be in (("gru", init_gru_model, "fused_q8"),
                               ("lstm", init_lstm_model, "fused"),
                               ("gru", init_gru_model, "fused")):
            prog = compile_delta_program(init(cs.SEED, cfg, device="cuda"),
                                         be, cell=cell)
            for n in SLOTS:
                wide = np.stack([frames + 0.01 * k for k in range(n)], 1)
                res, busy, du = {}, {}, {}
                for side in ("folded", "plain", "plain", "folded"):
                    DeltaStreamEngine.guard_folds = forced[side]
                    eng = warm(DeltaStreamEngine(prog, task, n_streams=n),
                               wide)
                    res.setdefault(side, []).extend(event_us(eng, wide))
                    eng.reset()
                    prof = cs.engine_profile(lambda: eng.step_many(wide[:48]),
                                             48, match="delta_unit_kernel")
                    busy.setdefault(side, []).append(
                        prof["device_busy_us_per_step"])
                    du.setdefault(side, []).append(prof["match_us_per_step"])
                    del eng
                DeltaStreamEngine.guard_folds = default
                print(json.dumps({
                    "choice": "frame guard", "path": f"{cell} {be}",
                    "n_streams": n,
                    "folds_by_default": bool(
                        prog.spec.frame_guard
                        and guard_fits(n, task.input_size)),
                    "event_us_per_step": res, "busy_us_per_step": busy,
                    "delta_unit_us_per_step": du, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
