"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed experts top-6,
2 shared experts. [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # per-expert FFN width (per assignment line)
    vocab=102400,
    use_mla=True,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head_dim=128,
    head_dim=192,              # qk_nope + qk_rope
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    expert_d_ff=1408,
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="silu",
)
