#!/usr/bin/env python3
"""Device times of ``deltagru_act`` and ``ops.deltagru_cell_fused`` through
the public functions of one or more source trees of the port, and where
the time of this checkout's ``deltagru_act`` goes, on one NVIDIA GPU.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:

* ``python3 tools/act_times.py SRC [SRC ...]``: each SRC a ``src``
  directory that holds ``repro_torch`` (this checkout's, or that of an
  older commit unpacked with ``git archive``). Each tree runs in a process
  of its own, since the package name is the same, and builds its own
  kernels; give the trees as ``A B B A`` to compare two on one card in one
  call. Per tree it times ``deltagru_act`` at the 2L-768H width (H = 768)
  at B = 1 and 8, warm and with a cold L2, and ``ops.deltagru_cell_fused``
  (two unpacked ``delta_spmv`` calls, every column fired, then
  ``deltagru_act``) at the network's layer shapes I = 40 and I = 768,
  B = 1, with the device timers of ``chip_smoke.py`` (CUDA-graph replay).
  Every tree draws the same inputs from the same seed.
* ``python3 tools/act_times.py --breakdown``: this checkout's kernel split
  into three parts at B = 1 and 8: an empty kernel at the same grid
  launched as the kernel is (the launch; also launched the ordinary way),
  a cut build that keeps every load and store but not the activations
  (the round trip), and the full kernel; then the design's choices one at
  a time: cut builds with an ordinary launch in place of the programmatic
  dependent one and with streaming stores (``st.global.cs``) in place of
  write-back ones, 32 to 256 threads a block, and ``tools/act_variants.cu``
  (two or four channels a thread with 8- or 16-byte loads and stores,
  each with write-back or streaming stores, beside its one-channel
  form), each checked against the plain version before it is timed.

One line per measurement, microseconds per call, with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H = 768
BATCHES = (1, 8)

# cut builds of this checkout's source: {cut: [(old, new), ...]}
CUTS = {
    # every load and store, the activations (expf, tanhf) left out
    "loads-stores": [(
        """    const float r = sigmoid_f(m_r);
    const float u = sigmoid_f(m_u);
    const float c = tanhf(__fadd_rn(m_xc, __fmul_rn(r, m_hc)));""",
        "    const float r = 0.5f, u = 0.5f, c = m_xc;")],
    # an ordinary launch in place of the programmatic dependent one (the
    # empty kernel of the build too)
    "plain launch": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    # streaming stores of the results in place of write-back ones
    "streaming stores": [(
        """    mo[0] = m_r;
    mo[H] = m_u;
    mo[2 * H] = m_xc;
    mo[3 * H] = m_hc;
    p.h_out[idx] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c),
                             __fmul_rn(u, hp));""",
        """    __stcs(mo, m_r);
    __stcs(mo + H, m_u);
    __stcs(mo + 2 * H, m_xc);
    __stcs(mo + 3 * H, m_hc);
    __stcs(p.h_out + idx, __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c),
                                    __fmul_rn(u, hp)));""")],
}


def _act_inputs(rng, b, h=H):
    import numpy as np
    import torch
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).cuda()
            for s in ((b, 4 * h), (b, 3 * h), (b, 3 * h), (b, h))]


def time_tree(src: Path) -> None:
    """Time ``deltagru_act`` and ``ops.deltagru_cell_fused`` of the
    package under ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.deltagru_cell import deltagru_act
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(cs.SEED)
    for b in BATCHES:
        args = _act_inputs(rng, b)
        warm = 1e3 * cs.device_ms(lambda: deltagru_act(*args))
        cold = 1e3 * cs.device_ms_cold(lambda: deltagru_act(*args))
        print(f"{src}: deltagru_act B={b} H={H}: {warm:.3f} us warm, "
              f"{cold:.3f} us cold [{smi}]", flush=True)
    for i_dim in (40, H):
        w_x, w_h = (torch.from_numpy(rng.normal(0, k ** -0.5, (3 * H, k))
                                     .astype(np.float32)).cuda()
                    for k in (i_dim, H))
        m, h, dx, dh = (torch.from_numpy(rng.normal(0, 1, s).astype(
            np.float32)).cuda() for s in ((1, 4 * H), (1, H), (1, i_dim),
                                          (1, H)))
        us = 1e3 * cs.device_ms(
            lambda: ops.deltagru_cell_fused(w_x, w_h, m, h, dx, dh))
        print(f"{src}: ops.deltagru_cell_fused I={i_dim} H={H} B=1, every "
              f"column fired: {us:.3f} us warm [{smi}]", flush=True)


def _build_cuts(out_dir: Path) -> dict:
    """Compile every cut of ``deltagru_cell.cu`` and ``act_variants.cu``,
    all at once: ``{cut: loaded library}``."""
    from repro_torch.kernels import _build
    jobs = {"variants": (out_dir / "variants.so", subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / "variants.so"),
         str(ROOT / "tools" / "act_variants.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))}
    for cut, edits in CUTS.items():
        text = (_build.CSRC / "deltagru_cell.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"cut {cut}: {old!r} is not in "
                                   "deltagru_cell.cu")
            text = text.replace(old, new)
        stem = cut.replace(" ", "_")
        path = out_dir / f"{stem}.cu"
        path.write_text(text)
        lib = out_dir / f"{stem}.so"
        jobs[cut] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for cut, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {cut}:\n{out}")
        libs[cut] = ctypes.CDLL(str(lib))
    return libs


def breakdown() -> None:
    """Empty kernel, loads and stores only, full kernel; then each choice
    of the design against its alternative."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import deltagru_cell as act
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(cs.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_cuts(Path(tmp))
        variants = libs.pop("variants").act_variant
        variants.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                             + [ctypes.c_void_p])
        variants.restype = ctypes.c_int
        libs["committed"] = _build.load("deltagru_cell.cu")
        for lib in libs.values():
            lib.deltagru_act_f32.argtypes = ([ctypes.c_void_p] * 6
                                             + [ctypes.c_int] * 4
                                             + [ctypes.c_void_p])
            lib.deltagru_act_f32.restype = ctypes.c_int
            lib.deltagru_act_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
            lib.deltagru_act_empty.restype = ctypes.c_int

        def stream():
            """The current stream (a CUDA graph captures on its own)."""
            return torch.cuda.current_stream().cuda_stream

        for b in BATCHES:
            ins = _act_inputs(rng, b)
            want = act.deltagru_act_ref(*ins)
            out = [torch.empty_like(z) for z in want]
            plan = act.deltagru_act_plan(b, H)

            def call(lib, plan):
                ptrs = [t.data_ptr() for t in ins + out]
                return lambda: lib.deltagru_act_f32(
                    *ptrs, b, H, plan.threads, plan.grid, stream())

            def timed(label, fn, check=True):
                if check:
                    out[0].fill_(float("nan"))
                    if fn():
                        raise RuntimeError(f"{label}: launch refused")
                    torch.cuda.synchronize()
                    err = max(float((a - w).abs().max())
                              for a, w in zip(out, want))
                    if not err <= cs.TOL_F32:
                        raise AssertionError(f"{label}: error {err}")
                us = 1e3 * cs.device_ms(fn)
                print(f"breakdown deltagru_act B={b} H={H} {label}: "
                      f"{us:.3f} us warm [{smi}]", flush=True)

            for label, build in (("", "committed"),
                                 (", plain launch", "plain launch")):
                empty = libs[build].deltagru_act_empty
                timed(f"empty kernel ({plan.grid} x {plan.threads}{label})",
                      lambda: empty(plan.grid, plan.threads, stream()),
                      check=False)
            timed("loads and stores only", call(libs["loads-stores"], plan),
                  check=False)
            timed(f"full kernel ({plan.grid} x {plan.threads})",
                  call(libs["committed"], plan))
            for cut in ("plain launch", "streaming stores"):
                timed(f"full kernel, {cut}", call(libs[cut], plan))
            for n in act.ACT_THREADS:
                other = dataclasses.replace(plan, threads=n, grid=min(
                    -(-plan.units // n), act.act_resident_blocks(n)))
                timed(f"{n} threads a block ({other.grid} x {n})",
                      call(libs["committed"], other))
            ptrs = [t.data_ptr() for t in ins + out]
            for v in (1, 2, 4):
                for stream_stores in (0, 1):
                    stores = "streaming" if stream_stores else "write-back"
                    timed(f"act_variants.cu: {v} channel(s) a thread, "
                          f"{4 * v}-byte loads, {stores} stores "
                          f"({-(-b * H // v // plan.threads)} x "
                          f"{plan.threads})",
                          lambda v=v, s=stream_stores: variants(
                              *ptrs, b, H, v, s, plan.threads, stream()))


def main(argv: list) -> int:
    if argv == ["--breakdown"]:
        breakdown()
        return 0
    if len(argv) == 2 and argv[0] == "--one":
        time_tree(Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for src in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", src])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
