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
  D = 2048) with fp32 and with bf16 ``r, k, v`` at [B, T] = [4, 128] (the
  LM prefill), [2, 32], [4, 1] (the LM decode), [1, 1] and [8, 1], and
  ``rglru_scan`` (W = 4096) at B = 1 and 8 and T = 1 and 128, warm and
  with a cold L2, with the device timers of ``chip_smoke.py`` (CUDA-graph
  replay), and prints a digest of each call's output bits. Every tree
  draws the same inputs from the same seed, so equal digests across trees
  are equal bits.
* ``python3 tools/scan_times.py --breakdown``: this checkout's scans split
  into three parts, at B = 1 and 8, T = 1: an empty kernel at the same grid
  launched as the scan is (the launch; also launched the ordinary way), a
  cut build that keeps every load and store of the kernel but none of its
  arithmetic, shuffles or barriers (the round trip), and the full kernel;
  then the design's choices one at a time: cut builds with an ordinary
  launch in place of the programmatic dependent one and with write-back
  stores of the state in place of streaming ones, and the other shapes
  (cut builds with 32 or 64 value columns a block for ``rwkv6_scan``, 32
  to 256 threads a block for ``rglru_scan``, 4-byte loads). At T > 1
  (``rwkv6_scan`` at [4, 128] and [2, 32], fp32 and bf16) the chunked
  kernel against the one-step kernel on the same operands (plan chunk 0,
  a cut build whose C entry takes it at T > 1), the chunked kernel at 16,
  32 and 64 value columns a block, at chunks of 8 and 16 steps (plans of
  this build) and of 64 (a cut build whose kChunk is 64), with y collected
  in shared memory and stored a chunk at a time (a cut build), with
  element copies in place of 16-byte ones, and with the y stores cut (a
  cut build that keeps the key sums: the most the stores cost), and the
  public call on contiguous operands against the model's [B, H, T, D]
  views of [B, T, H, D] tensors (read in place). Each but the last cut is
  checked against the plain version before it is timed.

* ``python3 tools/scan_times.py --mutants``: ``chip_smoke.py`` run in a
  copy of this checkout (its built kernels kept) once for each of
  ``MUTANTS``, faults of ``csrc/rwkv6_scan.cu``'s chunked kernel; each
  must fail phase 3 on an ``rwkv6_scan`` case. One line per mutant with
  the run's exit code, the phase it reached and its failure.

One line per measurement, microseconds per call, with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 1), (8, 1), (1, 128), (8, 128)]   # (B, T) of rglru_scan
WKV_SHAPES = [(4, 128), (2, 32), (4, 1), (1, 1), (8, 1)]  # rwkv6_scan's

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
        const float kv = outer(ki, v[c], TI{});
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
    # chunks of up to 64 steps for the chunked rwkv6_scan
    "chunk=64": {"rwkv6_scan.cu": [("constexpr int kChunk = 32;",
                                    "constexpr int kChunk = 64;")]},
    # the one-step rwkv6_scan kernel taken at any T (the C entry refuses it
    # at T > 1)
    "one-step at any T": {"rwkv6_scan.cu": [(
        ": (cols != kCols || T > 1))", ": cols != kCols)")]},
    # the chunked rwkv6_scan's y collected in shared memory (`chunk` rows
    # of `cols` fp32 beside the two buffers) and stored a chunk at a time,
    # 16 bytes a thread along the rows, behind one more barrier a chunk
    "y staged": {"rwkv6_scan.cu": [
        ("      float* y = a.y + base + (size_t)c * chunk * rs + c0 + y_col;",
         "      float* y = reinterpret_cast<float*>(\n"
         "          smem + chunk_smem(chunk, cols, sizeof(TI))) + y_col;"),
        ("sum_keys(prev, hi, mid, y + (size_t)(t - 1) * rs);",
         "sum_keys(prev, hi, mid, y + (t - 1) * cols);"),
        ("      sum_keys(prev, hi, mid, y + (size_t)(n - 1) * rs);\n",
         """      sum_keys(prev, hi, mid, y + (n - 1) * cols);
      __syncthreads();
      const float* ys = y - y_col;
      float* yg = a.y + base + (size_t)c * chunk * rs + c0;
      for (int q = threadIdx.x; q < n * cols / 4; q += blockDim.x) {
        const int t = q / (cols / 4), jj = (q % (cols / 4)) * 4;
        if constexpr (VEC) {
          *reinterpret_cast<float4*>(yg + (size_t)t * rs + jj) =
              *reinterpret_cast<const float4*>(ys + t * cols + jj);
        } else {
          for (int e = 0; e < 4; ++e)
            yg[(size_t)t * rs + jj + e] = ys[t * cols + jj + e];
        }
      }
"""),
        ("                           chunk_smem(chunk, cols, sizeof(TI)),",
         "                           chunk_smem(chunk, cols, sizeof(TI)) +\n"
         "                               (size_t)chunk * cols * 4,"),
        ("const int bytes = (int)chunk_smem(kChunk, kD, sizeof(float));",
         "const int bytes = (int)(chunk_smem(kChunk, kD, sizeof(float))\n"
         "                         + kChunk * kD * 4);"),
    ]},
    # the chunked rwkv6_scan's y stores cut: each step's key sum is added
    # into a register instead, stored once a chunk under a test that never
    # holds (the sums stay live): what the stores cost at most
    "no y store": {"rwkv6_scan.cu": [
        ("bool mid, float* y) {", "bool mid, float* y, float& sink) {"),
        ("  *y = sum;\n", "  sink += sum;\n"),
        ("      float acc[kVec], prev[kVec];",
         "      float acc[kVec], prev[kVec], sink = 0.0f;"),
        ("sum_keys(prev, hi, mid, y + (size_t)(t - 1) * rs);",
         "sum_keys(prev, hi, mid, y + (size_t)(t - 1) * rs, sink);"),
        ("      sum_keys(prev, hi, mid, y + (size_t)(n - 1) * rs);\n",
         "      sum_keys(prev, hi, mid, y + (size_t)(n - 1) * rs, sink);\n"
         "      if (sink == 1.2345e-30f) *y = sink;\n")]},
}

# faults of the chunked kernel phase 3 must catch: {name: (old, new)}
MUTANTS = {
    # the last, ragged chunk of a call dropped
    "dropped chunk tail": ("const int nchunks = (a.T + chunk - 1) / chunk;",
                           "const int nchunks = a.T / chunk;"),
    # a chunk's steps read from the buffer the next chunk is staged into
    "chunk buffers swapped": (
        "const Staged<TI> b = staged<TI>(smem, c & 1, chunk, cols);\n"
        "      const Rows rows",
        "const Staged<TI> b = staged<TI>(smem, (c + 1) & 1, chunk, cols);\n"
        "      const Rows rows"),
    # bf16 k v products kept in fp32, not rounded to bf16
    "k v unrounded in bf16": (
        "  lo = __uint_as_float(d << 16);\n"
        "  hi = __uint_as_float(d & 0xffff0000u);",
        "  lo = __uint_as_float(k2 << 16) * __uint_as_float(v2 << 16);\n"
        "  hi = __uint_as_float(k2 & 0xffff0000u) *\n"
        "       __uint_as_float(v2 & 0xffff0000u);"),
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


def _bf16(wkv):
    """The same operands with bf16 ``r, k, v`` (the bf16 models')."""
    import torch
    return [a.to(torch.bfloat16) for a in wkv[:3]] + wkv[3:]


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

    def report(name, b, t, fn):
        warm = 1e3 * cs.device_ms(fn)
        cold = 1e3 * cs.device_ms_cold(fn)
        # the outputs' bits: equal digests across trees, equal bits
        bits = hashlib.sha256(b"".join(
            z.contiguous().cpu().numpy().tobytes() for z in fn()))
        print(f"{src}: {name} B={b} T={t}: {warm:.3f} us warm, "
              f"{cold:.3f} us cold, outputs {bits.hexdigest()[:16]} "
              f"[{smi}]", flush=True)

    for b, t in WKV_SHAPES:
        wkv, _ = _inputs(rng, b, t)
        wkv16 = _bf16(wkv)
        report("rwkv6_scan", b, t, lambda: rwkv6_scan(*wkv))
        report("rwkv6_scan bf16", b, t, lambda: rwkv6_scan(*wkv16))
    for b, t in SHAPES:
        _, lru = _inputs(rng, b, t)
        report("rglru_scan", b, t, lambda: rglru_scan(*lru))


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
            for entry, args in (
                    ("rwkv6_scan_f32", [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
                    ("rwkv6_scan_bf16", [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
                    ("rglru_scan_f32", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
                    ("rwkv6_scan_prepare", [])):
                if hasattr(lib, entry):
                    fn = getattr(lib, entry)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            # every build's chunked kernel may take its largest chunk
            if hasattr(lib, "rwkv6_scan_prepare") and lib.rwkv6_scan_prepare():
                raise RuntimeError("rwkv6_scan_prepare failed")

        def stream():
            """The current stream (a CUDA graph captures on its own)."""
            return torch.cuda.current_stream().cuda_stream

        def wkv_call(lib, plan, ops_, out):
            r, k, v, w, u, s0 = ops_
            b, h, t, d = r.shape
            fn = (lib.rwkv6_scan_bf16 if r.dtype == torch.bfloat16
                  else lib.rwkv6_scan_f32)
            return lambda: fn(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), b, h, t, d, plan.cols, plan.chunk, 0,
                plan.vec, plan.grid, stream())

        def lru_call(lib, plan, ops_, out):
            x, a, h0 = ops_
            b, t, w = x.shape
            return lambda: lib.rglru_scan_f32(
                x.data_ptr(), a.data_ptr(), h0.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), b, t, w, plan.vec, plan.threads, plan.grid,
                stream())

        def timer(name, label_of, ops_, ref):
            """``timed(label, fn, check)`` for one scan's operands: each
            launch checked against the plain version (``check``), then
            timed warm."""
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
                print(f"breakdown {name} {label_of} {label}: {us:.3f} us "
                      f"warm [{smi}]", flush=True)
            return timed, out

        def chunk_plan(plan, dtype, **kw):
            """``plan`` (chunked, ``r, k, v`` of ``dtype``) with other
            columns or chunk; units, smem and grid to match."""
            p = dataclasses.replace(plan, **kw)
            units = plan.units * plan.cols // p.cols
            smem = wkv_mod.rwkv6_chunk_smem(p.chunk, p.cols, dtype)
            threads = 16 * p.cols // wkv_mod.RWKV6_KEYS
            return dataclasses.replace(
                p, threads=threads, units=units, smem=smem,
                grid=min(units, wkv_mod.rwkv6_chunk_resident_blocks(
                    threads, smem)))

        # T = 1 (and rglru_scan at T = 128): the launch, the round trip,
        # the design's choices
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
                "rglru_scan": (lru, lru_plan, lru_call,
                               lru_mod.rglru_scan_batched_ref,
                               "rglru_scan.cu", "rglru_scan_empty",
                               lru_others),
            }
            if t == 1:           # rwkv6_scan at T > 1: below
                cases["rwkv6_scan"] = (wkv, wkv_plan, wkv_call,
                                       wkv_mod.rwkv6_scan_batched_ref,
                                       "rwkv6_scan.cu", "rwkv6_scan_empty",
                                       wkv_others)
            for name, (ops_, plan, call, ref, src, empty,
                       others) in cases.items():
                timed, out = timer(name, f"B={b} T={t}", ops_, ref)
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

        # rwkv6_scan at T > 1, fp32 and bf16 r, k, v: the chunked kernel
        # against the one-step kernel, other columns a block, other chunks,
        # element copies
        lib = libs[("committed", "rwkv6_scan.cu")]
        for b, t in ((4, 128), (2, 32)):
            wkv, _ = _inputs(rng, b, t)
            for ops_ in (wkv, _bf16(wkv)):
                dtype = ops_[0].dtype
                plan = wkv_mod.rwkv6_scan_plan(b, 32, t, 64, dtype)
                step_units = b * 32 * 64 // wkv_mod.RWKV6_COLS
                step = dataclasses.replace(
                    plan, chunk=0, cols=wkv_mod.RWKV6_COLS, threads=256,
                    units=step_units, smem=0, grid=min(
                        step_units, wkv_mod.rwkv6_resident_blocks(256)))
                variants = [("full kernel", lib, plan),
                            ("one-step kernel", libs[("one-step at any T",
                                                      "rwkv6_scan.cu")],
                             step),
                            ("y staged in shared memory (chunk x columns "
                             "x 4 B more than shown)",
                             libs[("y staged", "rwkv6_scan.cu")], plan)]
                variants += [(f"{c} columns a block", lib,
                              chunk_plan(plan, dtype, cols=c))
                             for c in wkv_mod.RWKV6_CHUNK_COLS
                             if c != plan.cols]
                variants += [(f"chunks of {n}", lib,
                              chunk_plan(plan, dtype, chunk=n))
                             for n in (8, 16) if n < plan.chunk]
                if t > plan.chunk:
                    variants.append(("chunks of 64 (kChunk = 64)",
                                     libs[("chunk=64", "rwkv6_scan.cu")],
                                     chunk_plan(plan, dtype,
                                                chunk=min(t, 64))))
                variants.append(("element copies", lib,
                                 dataclasses.replace(plan, vec=1)))
                timed, out = timer("rwkv6_scan", f"{dtype} B={b} T={t}",
                                   ops_, wkv_mod.rwkv6_scan_batched_ref)
                for label, vlib, vplan in variants:
                    timed(f"{label} (chunk {vplan.chunk}, {vplan.cols} "
                          f"columns, {vplan.grid} x {vplan.threads}, "
                          f"{vplan.smem} B shared)",
                          wkv_call(vlib, vplan, ops_, out))
                timed("y stores cut, the sums kept (unchecked)", wkv_call(
                    libs[("no y store", "rwkv6_scan.cu")], plan, ops_, out),
                    check=False)
                # the public call on contiguous operands and on the model's
                # [B, H, T, D] views of [B, T, H, D] (read in place)
                tm = [z.movedim(2, 1).contiguous().movedim(1, 2)
                      for z in ops_[:4]] + ops_[4:]
                want = wkv_mod.rwkv6_scan_batched_ref(*ops_)
                for label, args in (("contiguous", ops_),
                                    ("views of [B, T, H, D]", tm)):
                    got = wkv_mod.rwkv6_scan(*args)
                    err = max(cs.scaled_err(a, bb) for a, bb in zip(got, want))
                    if not err <= cs.TOL_F32:
                        raise AssertionError(f"{label}: error {err}")
                    us = 1e3 * cs.device_ms(
                        lambda: wkv_mod.rwkv6_scan(*args))
                    print(f"breakdown rwkv6_scan {dtype} B={b} T={t} "
                          f"rwkv6_scan on {label} operands: {us:.3f} us "
                          f"warm [{smi}]", flush=True)


def mutants() -> int:
    """``chip_smoke.py`` in a copy of this checkout for each of
    ``MUTANTS``; 1 if one was not caught by phase 3."""
    missed = 0
    for name, (old, new) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            tree = Path(tmp) / "tree"
            shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(
                ".git", "chiprun_out", "_checkout", ".checkout",
                "__pycache__", "artifacts"))
            src = tree / "src" / "repro_torch" / "csrc" / "rwkv6_scan.cu"
            text = src.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"mutant {name}: {old!r} is not once in "
                                   "rwkv6_scan.cu")
            src.write_text(text.replace(old, new))
            proc = subprocess.run([sys.executable, "chip_smoke.py"],
                                  cwd=tree, capture_output=True, text=True,
                                  timeout=1200)
        out = proc.stdout + proc.stderr
        phases = re.findall(r"phase (\S+) took", out)
        failure = re.findall(r"AssertionError: (.*)", out)
        caught = (proc.returncode != 0 and phases[-1:] == ["2"]
                  and bool(failure) and "rwkv6_scan" in failure[-1])
        missed += not caught
        print(f"mutant {name}: exit {proc.returncode}, last phase done "
              f"{phases[-1] if phases else None}, "
              f"{'caught in phase 3' if caught else 'MISSED'}: "
              f"{failure[-1] if failure else out[-2000:]}", flush=True)
    return 1 if missed else 0


def main(argv: list) -> int:
    if argv == ["--breakdown"]:
        breakdown()
        return 0
    if argv == ["--mutants"]:
        return mutants()
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
