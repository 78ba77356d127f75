#!/usr/bin/env python3
"""Phase 5k of ``chip_smoke.py`` (``rank_phase``: the mesh paths over
ranks, one process a card over NCCL) alone, on one or more checkouts of
the port, on every card of the host.

Run from the root of a checkout on a host with CUDA cards and ``nvcc``:
``python3 tools/rank_times.py ROOT [ROOT ...]``, each ROOT the root of a
checkout (this one, ``.``, or an older commit unpacked there with ``git
archive``). Each ROOT runs in a process of its own, since the package name
is the same: it builds its own optimizer kernels (the fused AdamW and the
global norm, the only hand-written kernels the phase runs) and calls its
own ``chip_smoke.rank_phase``, which checks what it checks there and
prints its lines. Give the roots as ``A B B A`` to compare two on one host
in one call. After each root's lines, one JSON line: the root, the card's
name and power limit, the phase's seconds and its results (the rank
step's and the one-process step's replay walls, peaks, NCCL kernels and
their device time, the exchange's walls, the sharded steps (d) and the
steps that split the work over the ``model`` axis (e), the launcher's
losses). On a host with four cards, (e) runs llama3.2-1b at (1, 4) and
(2, 2) and granite-moe-3b-a800m at (2, 2):
``python3 tools/rank_times.py .`` there times them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

TIMEOUT_S = 1500


def one(root: Path) -> None:
    """Phase 5k of the checkout at ``root``, in this process."""
    os.chdir(root)
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    _build.build(("fused_adam.cu", "global_norm.cu"))
    built = time.perf_counter() - t0
    smi = chip_smoke.nvidia_smi_line()
    res = chip_smoke.rank_phase(torch.device("cuda"), smi)
    print(json.dumps({"root": str(root), "card": smi, "build_s": built,
                      "result": res}, default=str), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve())
        return 0
    rc = 0
    for root in argv:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--one", root], timeout=TIMEOUT_S)
        print(f"[rank_times] {root}: exit {p.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
