"""Model configurations (the paper's own networks)."""
