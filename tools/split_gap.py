#!/usr/bin/env python3
"""How far the bf16 train step over the ranks lies from one process's, for
each way of splitting the work, on several seeds.

For each seed, llama3.2-1b at full size in bf16 on [8, 128] (the state of
``init_lm(seed)``, the batch of ``lm_batch((seed, 13))``, ``chip_smoke``'s
learning rate): ``chip_smoke.RANK_STEPS`` eager steps in one process (the
reference, on a mesh listing the card once), then the same steps from the
same state under FSDP over every card of the host, one process a card
(``dist.ranks``), in each variant:

* ``dp``: the (world, 1) mesh, data parallel only;
* ``unsplit``: (2, world / 2) with the ``heads``, ``kv_heads``, ``ff`` and
  ``vocab`` rules empty, so that the ``model`` axis splits no work (every
  ``model`` rank computes the whole layer, the step before tensor
  parallelism);
* ``split``: (2, world / 2), tensor parallel as the port runs it (the
  row-parallel products of ``w_o`` and ``w_down``,
  ``models.common.row_parallel``, kept in fp32 until their sum over
  ``model`` and rounded to bf16 once, as one process rounds the whole
  product);
* ``parts16``: as ``split``, each rank's part of those products rounded
  to bf16 before the bf16 sum, as GSPMD's bf16 dot and all-reduce do;
* ``sum32``: as ``parts16``, with ``ranks.psum_disjoint``'s all-reduce of
  a bf16 tensor made in fp32 (the bf16 parts summed with no rounding
  between them, then rounded once);
* ``split14``: (1, world), tensor parallel as the port runs it.

Prints, for every seed and variant, each step's loss and clip norm as a
relative gap from the reference's (``chip_smoke.TOL_RANK_BF16_REL`` and
``TOL_RANK_NORM_REL`` are the phase 5k bounds) and the collectives the
steps issued (all-to-alls only where ``model`` splits the work), then one
JSON line of all of them with the card's name and power limit. Run from
the root of a checkout on a host with four cards:
``python3 tools/split_gap.py [--seeds 0 1 2 3] [--variants ...]``. With
``--device cpu --small`` it runs over four gloo processes at a size the
CPU takes (``SMALL``: llama3.2-1b's family in bf16 at a quarter of its
width, 4 layers, an 8192-token vocabulary), a check of the script and of
the same rounding at a smaller size, not the card's numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

VARIANTS = ("dp", "unsplit", "split", "parts16", "sum32", "split14")
SPAWN_TIMEOUT_S = 1500
# ``--small``: the overrides of ``ModelConfig.reduced`` (bf16, [8, 128])
SMALL = dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
             d_ff=2048, vocab=8192, dtype="bfloat16")


@contextlib.contextmanager
def _parts16(sum32: bool = False):
    """The split's row-parallel products in the operands' dtype, each
    rank's part rounded before the sum over the group; with ``sum32``,
    ``ranks.psum_disjoint`` (and ``psum``) all-reduce a bf16 or fp16
    tensor in fp32, rounding the sum once."""
    import torch
    from repro_torch.dist import ranks
    from repro_torch.models import attention, ffn
    orig = attention.row_parallel, ffn.row_parallel, ranks._Psum.forward

    def row_parallel(h, w, tp=None):
        y = h @ w
        return y if tp is None else ranks.psum_disjoint(y, tp.group)

    def forward(ctx, x, group, grads_summed):
        ctx.group, ctx.grads_summed = group, grads_summed
        if x.dtype in (torch.bfloat16, torch.float16):
            return ranks.all_reduce_(x.float(), group).to(x.dtype)
        return ranks.all_reduce_(x.clone(), group)
    attention.row_parallel = ffn.row_parallel = row_parallel
    if sum32:
        ranks._Psum.forward = staticmethod(forward)
    try:
        yield
    finally:
        attention.row_parallel, ffn.row_parallel, ranks._Psum.forward = orig


def _steps(step, state, batch, n):
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics


def rank_gaps(rank, small, seeds, variants):
    """On this rank: the reference's and each variant's metrics, each
    seed (only rank 0's are returned whole; the ranks' losses agree)."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_data import lm_batch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import ranks
    from repro_torch.dist.elastic import best_mesh
    from repro_torch.dist.sharding import AxisRules, use_mesh
    from repro_torch.launch.train import init_state
    from repro_torch.models.lm import init_lm
    from repro_torch.train.optim import (AdamConfig, constant_schedule,
                                         updates_in_place)
    from repro_torch.train.trainer import (init_train_state,
                                           make_lm_train_step_fn)
    if rank:
        sys.stdout = open(os.devnull, "w")
    dev = ranks.rank_device()
    world = torch.distributed.get_world_size()
    cfg = get_config(cs.LM_TRAIN_ARCH)
    cfg = cfg.reduced(**SMALL) if small else cfg
    batch_n, seq = cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ
    rules = AxisRules()
    whole = rules.with_overrides(heads=None, kv_heads=None, ff=None,
                                 vocab=None)
    opt = AdamConfig(schedule=constant_schedule(cs.TRAIN_LR))
    plans = {"dp": (world, rules, contextlib.nullcontext),
             "unsplit": (world // 2, whole, contextlib.nullcontext),
             "split": (world // 2, rules, contextlib.nullcontext),
             "parts16": (world // 2, rules, _parts16),
             "sum32": (world // 2, rules,
                       lambda: _parts16(sum32=True)),
             "split14": (1, rules, contextlib.nullcontext)}
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        batch = lm_batch((seed, 13), cfg, batch_n, seq, device=dev)
        step = make_lm_train_step_fn(cfg, opt)
        state = init_train_state(init_lm(seed, cfg, device=dev))
        with use_mesh(best_mesh(devices=[dev]), rules), updates_in_place():
            ref = _steps(step, state, batch, cs.RANK_STEPS)
        del state, step
        row = {"seed": seed, "one": ref, "runs": {}}
        for v in variants:
            data = plans[v][0]
            mesh = best_mesh(model_parallel=world // data)
            with use_mesh(mesh, plans[v][1]):
                state, st_sh = init_state(cfg, seed, dev, mesh, rules, rules)
                step = make_lm_train_step_fn(cfg, opt, state_sharding=st_sh)
                placed = shard_batch(batch, mesh, rules)
                before = dict(ranks.COLLECTIVES)
                with plans[v][2]():
                    got = _steps(step, state, placed, cs.RANK_STEPS)
                issued = {k: n - before[k] for k, n in
                          ranks.COLLECTIVES.items() if n - before[k]}
            del state, step, placed
            cs.free_card() if dev.type == "cuda" else None
            gaps = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in
                        zip(got, ref)] for k in ("loss", "grad_norm")}
            row["runs"][v] = {"mesh": mesh.shape, "metrics": got,
                              "gaps": gaps, "issued": issued}
            print(f"[split_gap] seed {seed} {v} {mesh.shape}: loss gaps "
                  + ", ".join(f"{g:.3e}" for g in gaps["loss"])
                  + "; clip norm gaps "
                  + ", ".join(f"{g:.3e}" for g in gaps["grad_norm"])
                  + f"; collectives {issued}", flush=True)
        row["seconds"] = time.perf_counter() - t0
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.dist import ranks
    if args.device == "cuda":
        from repro_torch.kernels import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build(("fused_adam.cu", "global_norm.cu"))
        world, card = torch.cuda.device_count(), cs.nvidia_smi_line()
    else:
        world, card = 4, "cpu"
    t0 = time.perf_counter()
    res = ranks.spawn_ranks(rank_gaps, world, args.device,
                            timeout=SPAWN_TIMEOUT_S,
                            args=(args.small, args.seeds, args.variants))
    print(json.dumps({"card": card, "world": world, "small": args.small,
                      "steps": cs.RANK_STEPS,
                      "bounds": {"loss": cs.TOL_RANK_BF16_REL,
                                 "grad_norm": cs.TOL_RANK_NORM_REL},
                      "seconds": time.perf_counter() - t0,
                      "seeds": res[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
