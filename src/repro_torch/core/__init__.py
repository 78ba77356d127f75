"""Delta encoding, thresholds, the performance model, the backend registry,
the DeltaGRU and DeltaLSTM stacks and compiled programs."""
