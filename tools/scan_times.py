#!/usr/bin/env python3
"""Device times of the two scans (``rwkv6_scan``, ``rglru_scan``) through the
public functions of one or more source trees of the port, and where the
time of this checkout's scans goes, on one NVIDIA GPU.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:

* ``python3 tools/scan_times.py SRC [SRC ...]``: each SRC a ``src``
  directory that holds ``repro_torch`` (this checkout's, or that of an
  older commit unpacked with ``git archive``). Each tree runs in a process
  of its own, since the package name is the same, and builds its own
  kernels; give the trees as ``A B B A`` to compare two on one card in one
  call. Per tree it times ``rwkv6_scan`` (H = 32 heads of 64, RWKV6 at
  D = 2048) and ``rglru_scan`` (W = 4096) at B = 1 and 8 and T = 1 and
  128, warm and with a cold L2, with the device timers of ``chip_smoke.py``
  (CUDA-graph replay). Every tree draws the same inputs from the same seed.
* ``python3 tools/scan_times.py --breakdown``: this checkout's scans split
  into three parts, at B = 1 and 8, T = 1 (at T = 128 only the plans): an
  empty kernel at the same grid
  launched as the scan is (the launch; also launched the ordinary way), a
  cut build that keeps every load and store of the kernel but none of its
  arithmetic, shuffles or barriers (the round trip), and the full kernel;
  then the design's choices one at a time: cut builds with an ordinary
  launch in place of the programmatic dependent one and with write-back
  stores of the state in place of streaming ones, and the other shapes
  (cut builds with 32 or 64 value columns a block for ``rwkv6_scan``, 32
  to 256 threads a block for ``rglru_scan``, 4-byte loads), each checked
  against the plain version before it is timed.

One line per measurement, microseconds per call, with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 1), (8, 1), (1, 128), (8, 128)]   # (B, T)

# cut builds of this checkout's sources: {cut: {source: [(old, new), ...]}}
_PLAIN_LAUNCH = ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")
_WB_STORES = [("  __stcs(p, x);\n", "  *p = x;\n")]
CUTS = {
    # every load and store, none of the arithmetic, shuffles or barriers
    "loads-stores": {
        "rwkv6_scan.cu": [(
            """      float p[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float kv = ki * v[c];
        p[c] = ri * (s[c] + ui * kv);
        s[c] = wi * s[c] + kv;
      }""", """#pragma unroll
      for (int c = 0; c < kVec; ++c) s[c] = ri + ki + wi + ui + v[c];
      if (tid < kCols) a.y[base + (size_t)t * kD + c0 + tid] = s[0];
      if (t >= 0) continue;
      float p[kVec] = {};""")],
        "rglru_scan.cu": [(
            """        const float norm =
            sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a[c], a[c])), 0.0f));
        h[c] = __fadd_rn(__fmul_rn(a[c], h[c]), __fmul_rn(norm, x[c]));""",
            "        h[c] = h[c] + a[c] + x[c];")],
    },
    # an ordinary launch in place of the programmatic dependent one (the
    # empty kernel of the build too)
    "plain launch": {"rwkv6_scan.cu": [_PLAIN_LAUNCH],
                     "rglru_scan.cu": [_PLAIN_LAUNCH]},
    # write-back stores of the state in place of streaming ones
    "write-back stores": {"rwkv6_scan.cu": _WB_STORES,
                          "rglru_scan.cu": _WB_STORES},
    # wider work units of rwkv6_scan: 32 or 64 value columns a block
    "cols=32": {"rwkv6_scan.cu": [("constexpr int kCols = 16;",
                                   "constexpr int kCols = 32;")]},
    "cols=64": {"rwkv6_scan.cu": [("constexpr int kCols = 16;",
                                   "constexpr int kCols = 64;")]},
}


def _inputs(rng, b, t):
    """Seeded operands of both scans on the card: ``(wkv, lru)``."""
    import numpy as np
    import torch

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    shape = (b, 32, t, 64)
    wkv = [dev(rng.normal(0, 1, shape)), dev(rng.normal(0, 1, shape)),
           dev(rng.normal(0, 1, shape)),
           dev(np.exp(-np.exp(rng.normal(-3, 1.5, shape)))),
           dev(rng.normal(0, 0.1, (32, 64))),
           dev(rng.normal(0, 1, (b, 32, 64, 64)))]
    lru = [dev(rng.normal(0, 1, (b, t, 4096))),
           dev(1 / (1 + np.exp(-rng.normal(2, 1, (b, t, 4096))))),
           dev(rng.normal(0, 1, (b, 4096)))]
    return wkv, lru


def time_tree(src: Path) -> None:
    """Time both scans of the package under ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(cs.SEED)
    for b, t in SHAPES:
        wkv, lru = _inputs(rng, b, t)
        for name, fn in (("rwkv6_scan", lambda: rwkv6_scan(*wkv)),
                         ("rglru_scan", lambda: rglru_scan(*lru))):
            warm = 1e3 * cs.device_ms(fn)
            cold = 1e3 * cs.device_ms_cold(fn)
            print(f"{src}: {name} B={b} T={t}: {warm:.3f} us warm, "
                  f"{cold:.3f} us cold [{smi}]", flush=True)


def _build_cuts(out_dir: Path) -> dict:
    """Compile every cut of both sources, all at once: ``{(cut, source):
    loaded library}``."""
    from repro_torch.kernels import _build
    jobs = {}
    for cut, edits_of in CUTS.items():
        for source, edits in edits_of.items():
            text = (_build.CSRC / source).read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"cut {cut}: {old!r} is not in "
                                       f"{source}")
                text = text.replace(old, new)
            stem = f"{cut.replace(' ', '_')}-{Path(source).stem}"
            path = out_dir / f"{stem}.cu"
            path.write_text(text)
            lib = out_dir / f"{stem}.so"
            jobs[(cut, source)] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def breakdown() -> None:
    """Empty kernel, loads and stores only, full kernel; then each choice
    of the design against its alternative."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as lru_mod
    from repro_torch.kernels import rwkv6_scan as wkv_mod
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(cs.SEED)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_cuts(Path(tmp))
        libs.update({("committed", s): _build.load(s)
                     for s in ("rwkv6_scan.cu", "rglru_scan.cu")})
        for lib in libs.values():
            for entry in ("rwkv6_scan_f32", "rglru_scan_f32"):
                if hasattr(lib, entry):
                    fn = getattr(lib, entry)
                    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p]
                                   if entry == "rwkv6_scan_f32" else
                                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int

        def stream():
            """The current stream (a CUDA graph captures on its own)."""
            return torch.cuda.current_stream().cuda_stream

        def wkv_call(lib, plan, ops_, out):
            r, k, v, w, u, s0 = ops_
            b, h, t, d = r.shape
            return lambda: lib.rwkv6_scan_f32(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), b, h, t, d, plan.cols, plan.vec, plan.grid,
                stream())

        def lru_call(lib, plan, ops_, out):
            x, a, h0 = ops_
            b, t, w = x.shape
            return lambda: lib.rglru_scan_f32(
                x.data_ptr(), a.data_ptr(), h0.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), b, t, w, plan.vec, plan.threads, plan.grid,
                stream())

        for b, t in SHAPES:
            wkv, lru = _inputs(rng, b, t)
            wkv_plan = wkv_mod.rwkv6_scan_plan(b, 32, t, 64)
            lru_plan = lru_mod.rglru_scan_plan(b, t, 4096)
            # the other shapes: a work unit of 32 or 64 value columns (cut
            # builds), 32 to 256 threads a block
            wkv_others = []
            for cols in (32, 64):
                units = b * 32 * 64 // cols
                grid = min(units, wkv_mod.rwkv6_resident_blocks(16 * cols))
                wkv_others.append((f"{cols} columns a block", f"cols={cols}",
                                   dataclasses.replace(
                                       wkv_plan, cols=cols, threads=16 * cols,
                                       units=units, grid=grid)))
            lru_others = [(f"{n} threads a block", "committed",
                           dataclasses.replace(lru_plan, threads=n, grid=min(
                               -(-lru_plan.units // n),
                               lru_mod.rglru_resident_blocks(n))))
                          for n in lru_mod.RGLRU_THREADS]
            cases = {
                "rwkv6_scan": (wkv, wkv_plan, wkv_call,
                               wkv_mod.rwkv6_scan_batched_ref,
                               "rwkv6_scan.cu", "rwkv6_scan_empty",
                               wkv_others),
                "rglru_scan": (lru, lru_plan, lru_call,
                               lru_mod.rglru_scan_batched_ref,
                               "rglru_scan.cu", "rglru_scan_empty",
                               lru_others),
            }
            for name, (ops_, plan, call, ref, src, empty,
                       others) in cases.items():
                want = ref(*ops_)
                out = [torch.empty_like(z) for z in want]

                def timed(label, fn, check=True):
                    if check:
                        out[0].fill_(float("nan"))
                        if fn():
                            raise RuntimeError(f"{label}: launch refused")
                        torch.cuda.synchronize()
                        err = max(cs.scaled_err(a, bb)
                                  for a, bb in zip(out, want))
                        if not err <= cs.TOL_F32:
                            raise AssertionError(f"{label}: error {err}")
                    us = 1e3 * cs.device_ms(fn)
                    print(f"breakdown {name} B={b} T={t} {label}: {us:.3f} "
                          f"us warm [{smi}]", flush=True)

                lib = libs[("committed", src)]

                def time_others():
                    timed(f"full kernel ({plan.grid} x {plan.threads})",
                          call(lib, plan, ops_, out))
                    for label, build, other in others:
                        timed(f"{label} ({other.grid} x {other.threads})",
                              call(libs[(build, src)], other, ops_, out))

                if t > 1:        # a prefill: the full kernel's shapes only
                    time_others()
                    continue
                for label, build in (("", "committed"),
                                     (", plain launch", "plain launch")):
                    empty_fn = getattr(libs[(build, src)], empty)
                    empty_fn.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
                    timed(f"empty kernel ({plan.grid} x {plan.threads}"
                          f"{label})",
                          lambda: empty_fn(plan.grid, plan.threads,
                                           stream()), check=False)
                timed("loads and stores only",
                      call(libs[("loads-stores", src)], plan, ops_, out),
                      check=False)
                for cut in ("plain launch", "write-back stores"):
                    timed(f"full kernel, {cut}",
                          call(libs[(cut, src)], plan, ops_, out))
                time_others()
                timed("4-byte loads", call(
                    lib, dataclasses.replace(plan, vec=1), ops_, out))


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
