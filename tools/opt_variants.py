#!/usr/bin/env python3
"""Design variants of the train steps' two optimizer kernels, timed in one
process on one NVIDIA GPU: copies of ``csrc/fused_adam.cu`` and
``csrc/global_norm.cu`` built with other values of their tuning constants
or with a text edit (the fused Adam without its streaming hints, with
its loads past L1 and normal in L2, dividing zeros as they are, or
handing out its tiles in a span a block instead of one sweep of the grid
over the tree), each launched through the
port's own wrapper (``kernels.fused_adam.fused_adam``,
``kernels.global_norm.global_norm``) with its library swapped in.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/opt_variants.py``. Each variant is first held against the
plain version at the 2L-768H GRU tree (the fused Adam bitwise in p, mu and
nu; the norm within ``chip_smoke.TOL_NORM_REL``), then timed at the two
main-path trees (the GRU's 5.41 M fp32 parameters by CUDA-graph replays,
also with 90 % of the gradients exactly 0 and their moments 0, as a
quantised step gives them; llama3.2-1b's 1.236 G bf16 ones by CUDA events
over eager calls), the
variants in turns and then in reverse order (A B ... B A), beside two
yardsticks of the card at each tree's size (a device copy of the fused
Adam's bytes, a sum over the norm's). Each fused Adam variant is also
timed inside the compiled 2L-768H GRU train steps, dense and QAT
(``make_gru_train_step`` as ``tools/train_times.py`` drives them, its
graph captured with the variant's library): the profiler's device time a
step of the fused Adam and the global norm, the step's busy time, and
its wall p50. One JSON line per variant and turn, with the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PLAIN = """
template <class T> __device__ __forceinline__ T ld_plain(const T* p) {
  return *p;
}
template <class T> __device__ __forceinline__ void st_plain(T* p, T v) {
  *p = v;
}
"""
# text edits of the source: plain loads and stores instead of the
# streaming hints
NO_HINTS = (("namespace {", "namespace {" + PLAIN), ("__ldcs(", "ld_plain("),
            ("__stcs(", "st_plain("))
# a zero numerator or root divided as it is, down the slow path
ZEROS_DIVIDED = (
    ("  const bool zero = y_pos && x == 0.0f;\n"
     "  const float q = __fdiv_rn(zero ? 1.0f : x, y);\n"
     "  return zero ? x : q;", "  return __fdiv_rn(x, y);"),
    ("  const bool zero = x == 0.0f;\n"
     "  const float r = __fsqrt_rn(zero ? 1.0f : x);\n"
     "  return zero ? x : r;", "  return __fsqrt_rn(x);"))
# the tile slots cut into one contiguous span a block, its warps taking
# them in turn, instead of one sweep of the grid
SPANS = ((
    "  const long long lo = static_cast<long long>(blockIdx.x) * kWarps;\n"
    "  const long long hi = slots;\n"
    "  const long long stride = static_cast<long long>(gridDim.x) * kWarps;",
    "  const long long lo = blockIdx.x * slots / gridDim.x;\n"
    "  const long long hi = (blockIdx.x + 1) * slots / gridDim.x;\n"
    "  const long long stride = kWarps;"),)
# the loads past L1 (ld.global.cg), normal in L2
LOADS_CG = (("return __ldcs(", "return __ldcg("),
            ("bf(__ldcs(", "bf(__ldcg("),
            ("const float4 a = __ldcs(", "const float4 a = __ldcg("),
            ("const uint2 u = __ldcs(", "const uint2 u = __ldcg("))
# name -> ({constant: value}, text edits)
ADAM_VARIANTS = {
    "adam base": ({}, ()),
    "adam spans": ({}, SPANS),
    "adam loads .cg": ({}, LOADS_CG),
    "adam zeros divided": ({}, ZEROS_DIVIDED),
    "adam no hints": ({}, NO_HINTS),
}
NORM_VARIANTS = {
    "norm base": {},
    "norm 3 blocks an SM": {"kBlocksPerSm": 3},
    "norm 8 groups a thread": {"kGroups": 8},
}


def variant_source(source: str, consts: dict, edits=()) -> str:
    text = (ROOT / "src/repro_torch/csrc" / source).read_text()
    for name, value in consts.items():
        text, n = re.subn(
            rf"(constexpr (?:int|long long|bool) {name} = )[^;]+;",
            rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{source}: no constant {name}")
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{source}: no {old!r} to edit")
        text = text.replace(old, new)
    return text


def build_all(out_dir: Path) -> dict:
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    specs = [(name, "fused_adam.cu", c, edits)
             for name, (c, edits) in ADAM_VARIANTS.items()]
    specs += [(name, "global_norm.cu", c, ())
              for name, c in NORM_VARIANTS.items()]
    for i, (name, source, consts, edits) in enumerate(specs):
        cu = out_dir / f"v{i}_{source}"
        cu.write_text(variant_source(source, consts, edits))
        lib = out_dir / f"v{i}.so"
        jobs[name] = (source, consts, lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (source, consts, lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        libs[name] = (source, consts, lib, regs)
    return libs


def use(source: str, consts: dict, lib: Path) -> None:
    """Swap the variant's library in under the wrapper, with its grid."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_adam as fa
    from repro_torch.kernels import global_norm as gn
    _build._LIBS[source] = ctypes.CDLL(str(lib))
    if source == "fused_adam.cu":
        fa.FA_BLOCKS_PER_SM = consts.get("kBlocksPerSm", 2)
    else:
        gn.NORM_BLOCKS_PER_SM = consts.get("kBlocksPerSm", 2)
        gn.NORM_GROUPS = consts.get("kGroups", 16)
        gn.NORM_CHUNK = gn.NORM_SPAN * gn.NORM_GROUPS


def step_times(cs, dev, smi, libs: dict, order) -> None:
    """Each fused Adam variant of ``order`` inside the compiled 2L-768H GRU
    train steps, dense and QAT: a step made and captured anew with the
    variant's library, 2 warm steps, 10 timed (wall p50), 5 profiled."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.data.synthetic import digit_batch
    from repro_torch.models.gru_rnn import PAPER_NETWORKS, init_gru_model
    from repro_torch.quant.qat import EDGEDRNN_QAT, FP32
    from repro_torch.train.optim import AdamConfig, constant_schedule
    from repro_torch.train.trainer import (init_train_state,
                                           make_gru_train_step)
    task = PAPER_NETWORKS["2L-768H"]
    gen = torch.Generator().manual_seed(cs.SEED + 2)
    batches = [digit_batch(gen, 32, 96, device=dev) for _ in range(12)]
    opt = AdamConfig(schedule=constant_schedule(cs.TRAIN_LR))
    stages = {"dense": (task, FP32, False),
              "qat": (dataclasses.replace(task, theta_x=cs.THETA,
                                          theta_h=cs.THETA),
                      EDGEDRNN_QAT, True)}
    for turn, names in enumerate((order, order[::-1])):
        for name in names:
            source, consts, lib, _ = libs[name]
            use(source, consts, lib)
            row = {"variant": name, "turn": turn, "in": "gru step",
                   "card": smi}
            for stage, (task_s, qat, use_delta) in stages.items():
                step = make_gru_train_step(task_s, opt, qat=qat,
                                           use_delta=use_delta)
                state = init_train_state(init_gru_model(cs.SEED, task,
                                                        device=dev))
                walls = []
                for i, b in enumerate(batches):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, b)
                    float(m["loss"])
                    if i >= 2:
                        walls.append(1e3 * (time.perf_counter() - t0))
                prof = cs.engine_profile(
                    lambda: [step(state, batches[-1]) for _ in range(5)], 5,
                    match=cs.OPT_KERNELS)
                row[stage] = {"step_p50_ms": float(np.median(walls)),
                              "busy_us": prof["device_busy_us_per_step"],
                              "us_by": prof["match_us_by"]}
                del step, state
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.fused_adam import fused_adam, fused_adam_ref
    from repro_torch.kernels.global_norm import global_norm, global_norm_ref
    from repro_torch.models.gru_rnn import PAPER_NETWORKS, init_gru_model
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import tree_leaves
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    libs = build_all(ROOT / "src/repro_torch/build/variants")
    trees = {}

    def gru():
        return init_gru_model(cs.SEED, PAPER_NETWORKS["2L-768H"], device=dev)
    for name, wd, large, zero_frac, init in (
            ("gru 2L-768H fp32", 0.0, False, 0.0, gru),
            ("gru 2L-768H fp32, 90 % zero gradients", 0.0, False, 0.9, gru),
            (f"{cs.LM_TRAIN_ARCH} full size bf16", 0.1, True, 0.0,
             lambda: init_lm(cs.SEED, get_config(cs.LM_TRAIN_ARCH),
                             device=dev))):
        p = tree_leaves(init())
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 29)
        g = [torch.randn(t.shape, generator=gen, device=dev).mul_(1e-3).to(
            t.dtype) for t in p]
        for t in g:     # a quantised network's gradients: many exact zeros
            t.mul_(torch.rand(t.shape, generator=gen, device=dev)
                   >= zero_frac)
        mu = [torch.zeros_like(t, dtype=torch.float32) for t in p]
        nu = [torch.zeros_like(t, dtype=torch.float32) for t in p]
        trees[name] = (p, g, mu, nu, wd, large)
    # each variant against the plain version at the GRU tree
    p, g, mu, nu, wd, _ = trees["gru 2L-768H fp32"]
    kw = dict(cs.adam_scalars(g, 8, 1.0, dev), b1=cs.ADAM_B1,
              b2=cs.ADAM_B2, eps=cs.ADAM_EPS, weight_decay=wd)
    ref = fused_adam_ref(p, g, mu, nu, **kw)
    norm_ref = global_norm_ref(g)
    for name, (source, consts, lib, regs) in libs.items():
        use(source, consts, lib)
        if source == "fused_adam.cu":
            got = fused_adam(p, g, mu, nu, **kw)
            bad, _ = cs.adam_compare(got, ref, [t.dtype for t in p])
            ok = not bad
        else:
            ok = cs.norm_close(global_norm(g), norm_ref, cs.TOL_NORM_REL)
        print(json.dumps({"variant": name, "registers": regs,
                          "against_plain": "ok" if ok else "differs"}),
              flush=True)
        if not ok:
            raise AssertionError(f"{name} differs from the plain version")
    # yardsticks of the card at these sizes: a device copy moving the
    # fused Adam's bytes (half read, half written), a sum reading the
    # norm's
    marks = {}
    for tname, (p, g, mu, nu, wd, large) in trees.items():
        timer = (lambda fn: cs.events_ms(fn, 5)) if large else cs.device_ms
        half = cs.adam_bytes(p, g) // 2
        src = torch.empty(half, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        g_bytes = sum(t.numel() * t.element_size() for t in g)
        flat = torch.empty(g_bytes // 4, dtype=torch.float32, device=dev)
        copy_ms = timer(lambda: dst.copy_(src))
        sum_ms = timer(lambda: flat.sum())
        marks[tname] = {"copy_ms": copy_ms,
                        "copy_bytes_per_s": 2 * half / copy_ms * 1e3,
                        "sum_ms": sum_ms,
                        "sum_bytes_per_s": flat.numel() * 4 / sum_ms * 1e3}
        del src, dst, flat
    print(json.dumps({"yardsticks": marks, "card": smi}), flush=True)
    names = list(libs)
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            source, consts, lib, _ = libs[name]
            use(source, consts, lib)
            row = {"variant": name, "turn": turn, "card": smi}
            for tname, (p, g, mu, nu, wd, large) in trees.items():
                kw = dict(cs.adam_scalars(g, 8, 1.0, dev), b1=cs.ADAM_B1,
                          b2=cs.ADAM_B2, eps=cs.ADAM_EPS, weight_decay=wd)
                timer = ((lambda fn: cs.events_ms(fn, 5)) if large
                         else cs.device_ms)
                if source == "fused_adam.cu":
                    row[tname] = timer(lambda: fused_adam(
                        p, g, mu, nu, out=(p, mu, nu), **kw))
                else:
                    row[tname] = timer(lambda: global_norm(g))
            print(json.dumps(row), flush=True)
    del trees, p, g, mu, nu
    torch.cuda.empty_cache()
    step_times(cs, dev, smi, libs, [n for n in names
                                    if libs[n][0] == "fused_adam.cu"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
