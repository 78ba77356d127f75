"""Delta encoding, delta-linear layers, thresholds, sparsity metrics, the
performance model, the backend registry, the DeltaGRU, DeltaLSTM, delta
RWKV6 and delta RG-LRU stacks and compiled programs."""
