"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), their plain
PyTorch versions, and the dispatch by tensor device."""
