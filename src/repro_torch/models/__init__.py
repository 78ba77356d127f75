"""The paper's networks: multi-layer DeltaGRU stacks with a head."""
