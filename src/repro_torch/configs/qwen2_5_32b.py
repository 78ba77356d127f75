"""qwen2.5-32b [dense] — GQA kv=8 with QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    norm="rmsnorm",
    activation="silu",
)
