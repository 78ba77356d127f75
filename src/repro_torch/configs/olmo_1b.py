"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    head_dim=128,
    norm="layernorm_np",       # OLMo's non-parametric LN
    tie_embeddings=True,
    rope_theta=10000.0,
    activation="silu",
)
