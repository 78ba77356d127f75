#!/usr/bin/env python3
"""Where the time of an int8/int4 layer step goes, on one NVIDIA GPU.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/q8_breakdown.py``. It builds ``src/repro_torch/csrc/
delta_q8.cu`` as committed and three cut copies of it, each with one more
stage removed (so they compute wrong results and are only timed):

* ``no-activation``: the LUT sigmoid / tanh return their input;
* ``no-walk``: the walk sees no fired block (no weight loads);
* ``no-prologue``: neither the deltas are staged nor any block walked.

Then, at the paper's 2L-768H shapes and B = 1, it times each build's GRU
and LSTM steps (int8 and int4, one ``fused_q8`` / ``fused_q4`` layer pair,
about 10 % and 100 % of the column blocks fired) with the device timer of
``chip_smoke.py`` (CUDA-graph replay, weights in L2), the buffered form of
the committed build with its planned ring and with a stage for every fired
block, and two launches of an empty kernel (the floor). One line per
measurement, microseconds per 2-layer step, with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CUTS = {
    "no-activation": [
        ("return grid_round(sigmoid_f(grid_round(x, act)), lut);",
         "return x;"),
        ("return grid_round(tanhf(grid_round(x, act)), lut);", "return x;")],
    "no-walk": [
        ("const int n =\n        delta_walk::warp_fired_blocks(",
         "const int n = 0 * delta_walk::warp_fired_blocks(")],
    "no-prologue": [
        ("    delta_walk::stage_deltas<4>(",
         "    if (b0 < 0) delta_walk::stage_deltas<4>("),
        ("const int n =\n        delta_walk::warp_fired_blocks(",
         "const int n = 0 * delta_walk::warp_fired_blocks(")],
}


def build(out_dir: Path) -> dict:
    """Compile the committed source and each cut, all at once; returns
    ``{name: loaded library}``."""
    from repro_torch.kernels import _build
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    text = (csrc / "delta_q8.cu").read_text()
    sources = {"committed": csrc / "delta_q8.cu"}
    for name, edits in CUTS.items():
        cut = text
        for old, new in edits:
            if old not in cut:
                raise RuntimeError(f"cut {name}: {old!r} is not in the source")
            cut = cut.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(cut)
        sources[name] = path
    jobs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def step_fn(lib, gates, layout, buffered, stages=None):
    """A launcher of one layer step of ``lib`` on fixed operands, with the
    launch plan of ``kernels/delta_q8.py`` (``stages`` overrides the ring
    depth of the buffered form)."""
    import torch

    from repro_torch.kernels import delta_q8 as q8
    cell = "gru" if gates == 3 else "lstm"
    fn = getattr(lib, f"delta_q8_{cell}_step")
    fn.argtypes = ([ctypes.c_void_p] * (9 if gates == 3 else 10)
                   + [ctypes.c_int] * 14 + [ctypes.c_float] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    k = layout.ip + layout.hk
    plan = q8.q8_launch_plan(gates, layout.weight_bits, layout.block_k,
                             layout.ip, k, layout.hidden_size, 1, buffered,
                             torch.cuda.current_device())
    ring, smem = plan.stages, plan.smem
    if stages is not None:
        wbk = layout.block_k // (2 if layout.weight_bits == 4 else 1)
        ring = max(plan.stages, stages)
        smem = q8.q8_smem_bytes(gates, wbk, k, layout.block_k, plan.chunk,
                                ring, q8.Q8_ROWS + 1)

    def run(m, s, dx, dh, outs):
        err = fn(layout.w_q.data_ptr(), layout.scales.data_ptr(),
                 layout.b4.data_ptr(), m.data_ptr(), s.data_ptr(),
                 dx.data_ptr(), dh.data_ptr(), *(o.data_ptr() for o in outs),
                 1, layout.input_size, layout.hidden_size, layout.hp, k,
                 layout.ip, layout.block_k, layout.weight_bits, int(buffered),
                 q8.Q8_INSTANCES.index(plan.instance), plan.chunk,
                 ring, smem, plan.device, layout.act_scale,
                 layout.act_min, layout.act_max, layout.lut_scale,
                 layout.lut_min, layout.lut_max,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"delta_q8_{cell}_step: CUDA error {err}")
    return run


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("q8_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.edgedrnn import CONFIG_2L768H
    from repro_torch.core.program import compile_delta_program
    from repro_torch.kernels import _build
    from repro_torch.models.gru_rnn import init_gru_model, init_lstm_model

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "q8_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    libs = build(out_dir)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    empty = libs["committed"].delta_q8_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int

    from repro_torch.kernels.delta_q8 import q8_launch_plan
    grid = q8_launch_plan(4, 8, 128, 768, 1536, 768, 1, False)

    def floor():
        empty(grid.grid, grid.threads, torch.cuda.current_stream().cuda_stream)

    print(f"launch floor (2 empty launches, {grid.grid} x {grid.threads}): "
          f"{2e3 * cs.device_ms(floor):.2f} us [{smi}]", flush=True)
    for cell, init in (("lstm", init_lstm_model), ("gru", init_gru_model)):
        gates = 4 if cell == "lstm" else 3
        model = init(cs.SEED, CONFIG_2L768H, device="cuda")
        for be in ("fused_q8", "fused_q4"):
            layouts = compile_delta_program(model, be, cell=cell).layouts
            for fire in (0.1, 1.0):
                ops = []
                for lay in layouts:
                    ins, _ = cs.layer_inputs(rng, 1, lay, fire, True)
                    m, h, c, dx, dh = (torch.from_numpy(a).to(dev)
                                       for a in ins)
                    s = h if cell == "gru" else c
                    outs = [torch.empty_like(m), torch.empty_like(s)]
                    if gates == 4:
                        outs.append(torch.empty_like(s))
                    ops.append((lay, (m, s, dx, dh, outs)))
                runs = {name: [step_fn(lib, gates, lay, False)
                               for lay, _ in ops]
                        for name, lib in libs.items()}
                committed = libs["committed"]
                runs["buffered"] = [step_fn(committed, gates, lay, True)
                                    for lay, _ in ops]
                runs["buffered, every block in flight"] = [
                    step_fn(committed, gates, lay, True, stages=lay.nbk)
                    for lay, _ in ops]
                times = {}
                for name, fns in runs.items():
                    times[name] = 1e3 * sum(
                        cs.device_ms(lambda f=f, a=args: f(*a))
                        for f, (_, args) in zip(fns, ops))
                line = ", ".join(f"{k} {v:.2f}" for k, v in times.items())
                print(f"{cell} {be} fire={fire} us per 2-layer step: {line} "
                      f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
