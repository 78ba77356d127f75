"""smollm-360m [dense] — llama-arch small, GQA kv=5.
[hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="silu",
)
