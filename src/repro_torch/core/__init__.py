"""Delta encoding, thresholds, the performance model, the backend registry,
the DeltaGRU stack and compiled programs."""
