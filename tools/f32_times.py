#!/usr/bin/env python3
"""Device times of the fp32 layer steps and of ``delta_spmv`` through the
public functions of one or more source trees of the port, on one NVIDIA
GPU.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/f32_times.py SRC [SRC ...]``, each SRC a ``src`` directory
that holds ``repro_torch`` (this checkout's, or that of an older commit
unpacked with ``git archive``). Each tree runs in a process of its own,
since the package name is the same, and builds its own kernels; give the
trees as ``A B B A`` to compare two on one card in one call.

Per tree it times ``deltagru_seq_step`` and ``deltalstm_seq_step`` at the
paper's 2L-768H shapes, B = 1 and B = 8 (as the 8-slot batcher launches
them), each stream firing about 10 % or 100 % of the column blocks, and
``delta_spmv`` over the four fp32 calls of one RWKV6 (D = 2048) and one
RG-LRU (W = 4096) layer step at B = 1, 0 %, about 10 % and 100 % fired,
with the device timer of ``chip_smoke.py`` (CUDA-graph replay). Every tree
draws the same inputs from the same seed. One line per measurement,
microseconds per 2-layer step or per layer step, with the card's name and
power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LM_CALLS = {"rwkv6": [(2048, 2048)] * 3 + [(2048, 64)],
            "rglru": [(4096, 4096)] * 4}


def time_tree(src: Path) -> None:
    """Time the fp32 steps and delta_spmv of the package under ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs.edgedrnn import CONFIG_2L768H
    from repro_torch.core.program import compile_delta_program
    from repro_torch.kernels.delta_spmv import delta_spmv, pack_spmv_weights
    from repro_torch.kernels.deltagru_seq import deltagru_seq_step
    from repro_torch.kernels.deltalstm_seq import deltalstm_seq_step
    from repro_torch.models.gru_rnn import init_gru_model, init_lstm_model
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(cs.SEED)
    cells = (("lstm", init_lstm_model, deltalstm_seq_step),
             ("gru", init_gru_model, deltagru_seq_step))
    for cell, init, step in cells:
        model = init(cs.SEED, CONFIG_2L768H, device="cuda")
        layouts = compile_delta_program(model, "fused", cell=cell).layouts
        for b in (1, 8):
            for fire in (0.1, 1.0):
                us = 0.0
                for lay in layouts:
                    ins, _ = cs.layer_inputs(rng, b, lay, fire, False)
                    gpu = [torch.from_numpy(a).cuda() for a in ins]
                    us += 1e3 * cs.device_ms(
                        lambda: cs.run_step(cell, step, lay, gpu))
                print(f"{src}: {cell} fused B={b} fire={fire}: {us:.2f} us "
                      f"per 2-layer step [{smi}]", flush=True)
    for cell, calls in LM_CALLS.items():
        for fire in (0.0, 0.1, 1.0):
            us = 0.0
            for i_dim, o_dim in calls:
                w, dx, acc, _ = cs.spmv_case(rng, i_dim, o_dim, 1, fire)
                wp = pack_spmv_weights(torch.from_numpy(w)).cuda()
                dx, acc = (torch.from_numpy(a).cuda() for a in (dx, acc))
                us += 1e3 * cs.device_ms(
                    lambda: delta_spmv(wp, dx, acc, packed=True,
                                       out_dim=o_dim))
            print(f"{src}: delta_spmv {cell} layer step (4 calls) B=1 "
                  f"fire={fire}: {us:.2f} us [{smi}]", flush=True)


def main(argv: list) -> int:
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
