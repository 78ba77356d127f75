"""Build the CUDA sources into shared libraries and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface (pointers and the stream
as ``void*``, sizes as ``int``, each entry returning ``cudaGetLastError()``),
so it compiles with ``nvcc`` alone in seconds, without PyTorch's headers.
A library is built at first use into ``repro_torch/build/`` (listed in
``.gitignore``), under a name keyed by a hash of its source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged one
is reused.

:func:`build` starts one ``nvcc`` per source, all together, and waits for
them; :func:`load` builds what is missing and returns the loaded library.
Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
SOURCES = ("deltagru_seq.cu", "deltalstm_seq.cu", "delta_q8.cu",
           "delta_spmv.cu", "rwkv6_scan.cu", "rglru_scan.cu",
           "deltagru_cell.cu", "delta_unit.cu", "engine_epilogue.cu",
           "fused_adam.cu", "global_norm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels build only where the CUDA toolkit is "
                       "installed")


def library_path(source: str) -> Path:
    """Where the library of ``source`` is built: the name carries a hash of
    the source, the shared headers of ``csrc`` and the flags."""
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    key = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{key}.so"


def build(sources=SOURCES) -> dict:
    """Compile every source not yet built, one ``nvcc`` each, all started
    together. Returns ``{source: compiler output}`` (``-Xptxas -v`` prints
    each kernel's registers, shared memory and spills) for the sources it
    compiled. Raises with the compiler output if one fails."""
    jobs = []
    try:
        for source in sources:
            target = library_path(source)
            if target.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((source, target, tmp, proc))
        logs = {}
        for source, target, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {source}:\n{out}")
            os.replace(tmp, target)
            logs[source] = out
        return logs
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if missing."""
    lib = _LIBS.get(source)
    if lib is None:
        target = library_path(source)
        if not target.exists():
            build((source,))
        lib = _LIBS[source] = ctypes.CDLL(str(target))
    return lib
