#!/usr/bin/env python3
"""Device times of the int8/int4 layer steps at one stream and at eight,
through the public step functions of one or more source trees of the port,
on one NVIDIA GPU.

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
``python3 tools/q8_tile_times.py SRC [SRC ...]``, each SRC a ``src``
directory that holds ``repro_torch`` (this checkout's, or that of an older
commit unpacked with ``git archive``). Each tree runs in a process of its
own, since the package name is the same, and builds its own kernels; give
the trees as ``A B B A`` to compare two on one card in one call.

Per tree it times ``deltagru_q8_step`` and ``deltalstm_q8_step``, int8 and
int4, plain and ``buffered=True``, at the paper's 2L-768H shapes, B = 1
(the one-stream instance) and B = 8 (the tile instance, as the 8-slot
batcher launches it), each stream firing about 10 % or 100 % of the column
blocks, with the device timer of ``chip_smoke.py`` (CUDA-graph replay,
weights in L2). Every tree draws the same inputs from the same seed. One
line per measurement, microseconds per 2-layer step, with the card's name
and power limit.
"""
from __future__ import annotations

import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_tree(src: Path) -> None:
    """Time every int8/int4 step of the package under ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs.edgedrnn import CONFIG_2L768H
    from repro_torch.core.program import compile_delta_program
    from repro_torch.kernels.delta_q8 import (deltagru_q8_step,
                                              deltalstm_q8_step)
    from repro_torch.models.gru_rnn import init_gru_model, init_lstm_model
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(cs.SEED)
    cells = (("lstm", init_lstm_model, deltalstm_q8_step),
             ("gru", init_gru_model, deltagru_q8_step))
    for cell, init, step in cells:
        model = init(cs.SEED, CONFIG_2L768H, device="cuda")
        for be in ("fused_q8", "fused_q4"):
            layouts = compile_delta_program(model, be, cell=cell).layouts
            for b in (1, 8):
                for fire in (0.1, 1.0):
                    args = []
                    for lay in layouts:
                        ins, _ = cs.layer_inputs(rng, b, lay, fire, True)
                        args.append((lay, [torch.from_numpy(a).cuda()
                                           for a in ins]))
                    for buffered in (False, True):
                        fn = functools.partial(step, buffered=buffered)
                        us = 1e3 * sum(
                            cs.device_ms(lambda lay=lay, gpu=gpu:
                                         cs.run_step(cell, fn, lay, gpu))
                            for lay, gpu in args)
                        print(f"{src}: {cell} {be} buffered={buffered} "
                              f"B={b} fire={fire}: {us:.2f} us per 2-layer "
                              f"step [{smi}]", flush=True)


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
