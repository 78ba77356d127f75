"""granite-moe-3b-a800m [moe] — GQA kv=8, 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                  # per-expert FFN width (per assignment line)
    vocab=49155,
    head_dim=64,
    n_experts=40,
    top_k=8,
    n_shared_experts=0,
    expert_d_ff=512,
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="silu",
)
