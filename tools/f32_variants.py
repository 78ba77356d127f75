#!/usr/bin/env python3
"""What the shape choices of the fp32 layer step and of ``delta_spmv`` are
worth, on one NVIDIA GPU.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/f32_variants.py``. It builds copies of
``src/repro_torch/csrc/delta_step_f32.cuh`` (with ``deltagru_seq.cu`` and
``deltalstm_seq.cu``) and of ``delta_spmv.cu`` with one constant changed
each, and times every copy through its C entry, each result checked
against the plain version:

* the fp32 step (2L-768H, one 2-layer step at B = 1 and 8, about 10 % and
  100 % of the column blocks fired): the committed shape (3 warps a row,
  unroll 8) and every instance at one, two or three warps a row with
  unroll 8 or 16;
* ``delta_spmv`` (the four fp32 calls of one RWKV6 and one RG-LRU layer
  step at B = 1, 0 %, ~10 % and 100 % fired): the committed plan, the same
  kernel launched one block a row group (one row a warp, the grid the
  row groups need, which runs in two waves at 4096 rows), and builds with
  unroll 4 and 16.

Times are device times of CUDA-graph replay (``chip_smoke.device_ms``, the
weights warm in L2 where they fit), in microseconds, with the card's name
and power limit.
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

CSRC = ROOT / "src" / "repro_torch" / "csrc"
SHAPE = ("constexpr int kSplit = 3;   // warps a row's walk is spread over\n"
         "constexpr int kUnroll = 8;  // float4 loads a lane has in flight\n")
UNROLL = "constexpr int kUnroll = 8;"


def step_shape(unroll: int, split: int) -> str:
    return (f"constexpr int kSplit = {split};\n"
            f"constexpr int kUnroll = {unroll};\n")


# fp32 step copies: name -> (split, unroll); the committed shape is 3, 8
STEP = {"committed": (3, 8)}
STEP.update({f"split{s}_u{u}": (s, u) for s in (1, 2, 3) for u in (8, 16)
             if (s, u) != (3, 8)})
# delta_spmv copies: name -> kUnroll
SPMV = {"committed": 8, "unroll4": 4, "unroll16": 16}


def build(out: Path) -> dict:
    """Every copy, one nvcc each, all at once: ``{(kind, name, source):
    loaded library}``."""
    from repro_torch.kernels import _build
    import chip_smoke as cs
    header = (CSRC / "delta_step_f32.cuh").read_text()
    spmv = (CSRC / "delta_spmv.cu").read_text()
    if SHAPE not in header or UNROLL not in spmv:
        raise RuntimeError("the sources no longer hold the shape constants "
                           "this tool changes")
    jobs = {}
    for name, (split, unroll) in STEP.items():
        d = out / f"step_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "delta_step_f32.cuh").write_text(
            header.replace(SHAPE, step_shape(unroll, split)))
        for cell in ("deltagru_seq", "deltalstm_seq"):
            (d / f"{cell}.cu").write_text((CSRC / f"{cell}.cu").read_text())
            jobs[("step", name, cell)] = d / f"{cell}.cu"
    for name, unroll in SPMV.items():
        d = out / f"spmv_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "delta_spmv.cu").write_text(
            spmv.replace(UNROLL, f"constexpr int kUnroll = {unroll};"))
        jobs[("spmv", name, "delta_spmv")] = d / "delta_spmv.cu"
    procs = {key: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-I",
         str(CSRC), "-o", str(src.with_suffix(".so")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, src in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{text}")
        for line in cs.ptxas_summary(text):
            print(*key, line, flush=True)
        libs[key] = ctypes.CDLL(str(jobs[key].with_suffix(".so")))
    return libs


def time_steps(libs, smi) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.edgedrnn import CONFIG_2L768H
    from repro_torch.core.program import compile_delta_program
    from repro_torch.kernels import delta_step_f32 as f32
    from repro_torch.kernels.deltagru_seq import deltagru_seq_step_ref
    from repro_torch.kernels.deltalstm_seq import deltalstm_seq_step_ref
    from repro_torch.models.gru_rnn import init_gru_model, init_lstm_model
    dev = torch.device("cuda")
    cells = {"gru": (3, init_gru_model, deltagru_seq_step_ref),
             "lstm": (4, init_lstm_model, deltalstm_seq_step_ref)}
    for cell, (gates, init, ref) in cells.items():
        layouts = compile_delta_program(init(cs.SEED, CONFIG_2L768H,
                                             device="cuda"), "fused",
                                        cell=cell).layouts
        for name, (split, _) in STEP.items():
            fn = getattr(libs[("step", name, f"delta{cell}_seq")],
                         f"delta{cell}_seq_step_f32")
            fn.argtypes = ([ctypes.c_void_p] * (gates + 4)
                           + [ctypes.c_int] * 11 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            res = []
            for b in (1, 8):
                inst = "one_stream" if b == 1 else "tile"
                for fire in (0.1, 1.0):
                    rng = np.random.default_rng(cs.SEED)
                    us = 0.0
                    for lay in layouts:
                        ins, _ = cs.layer_inputs(rng, b, lay, fire, False)
                        m, h, c, dx, dh = (torch.from_numpy(a).to(dev)
                                           for a in ins)
                        s = c if gates == 4 else h
                        outs = [torch.empty_like(m)] + [
                            torch.empty_like(s) for _ in range(gates - 2)]
                        k = lay.ip + lay.hk
                        chunk = min(b, f32.F32_MAX_STREAMS)
                        smem = (f32.f32_smem_bytes(k, lay.block_k, chunk)
                                + 4 * f32.F32_ROWS * (split - f32.F32_SPLIT)
                                * (k // lay.block_k + 64))
                        args = [lay.w, m, s, dx, dh, *outs]

                        def run():
                            err = fn(*(t.data_ptr() for t in args), b,
                                     lay.input_size, lay.hidden_size, lay.hp,
                                     k, lay.ip, lay.block_k,
                                     f32.F32_INSTANCES.index(inst), chunk,
                                     smem, dev.index or 0,
                                     torch.cuda.current_stream().cuda_stream)
                            if err:
                                raise RuntimeError(f"{name}: CUDA error {err}")

                        us += 1e3 * cs.device_ms(run)
                        want = cs.run_step(cell, ref, lay, [m, h, c, dx, dh])
                        err = max(float((x - y).abs().max())
                                  for x, y in zip(outs, want))
                        if err > cs.TOL_F32:
                            raise AssertionError(f"{name} {cell}: {err}")
                    res.append(f"B={b} fire={fire} {us:.2f}")
            print(f"step {cell} {name}: {', '.join(res)} us per 2-layer "
                  f"step [{smi}]", flush=True)


def time_spmv(libs, smi) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import delta_spmv as sp
    dev = torch.device("cuda")
    calls = {"rwkv6": [(2048, 2048)] * 3 + [(2048, 64)],
             "rglru": [(4096, 4096)] * 4}
    runs = [(name, "plan") for name in SPMV] + [("committed", "groups")]
    for cell, shapes in calls.items():
        data = {}
        rng = np.random.default_rng(cs.SEED)
        for fire in (0.0, 0.1, 1.0):
            data[fire] = []
            for i_dim, o_dim in shapes:
                w, dx, acc, _ = cs.spmv_case(rng, i_dim, o_dim, 1, fire)
                wp = sp.pack_spmv_weights(torch.from_numpy(w)).to(dev)
                dx, acc = (torch.from_numpy(a).to(dev) for a in (dx, acc))
                data[fire].append((i_dim, o_dim, wp, dx, acc))
        for name, grid in runs:
            fn = libs[("spmv", name, "delta_spmv")].delta_spmv
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            res = []
            for fire, ops in data.items():
                us = 0.0
                for i_dim, o_dim, wp, dx, acc in ops:
                    plan = sp.spmv_launch_plan(o_dim, i_dim, wp.shape[1],
                                               128, 1, torch.float32)
                    rows, blocks = plan.rows, plan.grid
                    if grid == "groups":  # one block a row group
                        rows = 1
                        blocks = -(-o_dim // sp.SPMV_ROWS) * plan.split
                    out = torch.empty_like(acc)

                    def run():
                        err = fn(wp.data_ptr(), dx.data_ptr(), acc.data_ptr(),
                                 out.data_ptr(), 1, i_dim, o_dim, wp.shape[1],
                                 128, 0, 0, 0, 0,
                                 sp.SPMV_INSTANCES.index(plan.instance),
                                 plan.chunk, plan.split, blocks, rows,
                                 plan.smem, dev.index or 0,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")

                    us += 1e3 * cs.device_ms(run)
                    want = sp.delta_spmv_ref(wp[:o_dim, :i_dim], dx, acc)
                    if cs.scaled_err(out, want) > cs.TOL_F32:
                        raise AssertionError(f"{name} {cell} fire={fire}")
                res.append(f"fire={fire} {us:.2f}")
            label = name if grid == "plan" else "one block a row group"
            print(f"delta_spmv {cell} layer step (4 calls) B=1 {label}: "
                  f"{', '.join(res)} us [{smi}]", flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("f32_variants: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    out = _build.BUILD_DIR / "f32_variants"
    t0 = time.perf_counter()
    libs = build(out)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    time_steps(libs, smi)
    time_spmv(libs, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
