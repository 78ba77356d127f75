"""EdgeDRNN on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

The package mirrors ``repro`` module for module (``repro/core/deltagru.py``
is ``repro_torch/core/deltagru.py``) and imports neither JAX nor anything
of ``repro``. Its main path is the paper's deployment: compile a DeltaGRU
or DeltaLSTM stack, or a delta-ized RWKV6 or RG-LRU stack, once
(:func:`repro_torch.core.program.compile_delta_program`), then stream it
frame by frame through :class:`repro_torch.serve.engine.DeltaStreamEngine`.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU with ``device="cpu"``; with no card and no ``device="cpu"`` they
raise. Kernel dispatch is by tensor device (:mod:`repro_torch.kernels.ops`):
a CPU tensor runs a kernel's plain PyTorch version, a CUDA tensor launches
the hand-written CUDA kernel built from ``csrc/`` at first use.
"""
