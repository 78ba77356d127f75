"""llama-3.2-vision-11b [vlm] — 40L text backbone with cross-attention image
layers every 5th layer; vision tower is a stub providing patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    cross_attn_every=5,        # 8 cross-attention layers in 40
    n_image_tokens=1601,       # 1 tile x (40x40+1) patches
    vision_dim=7680,
    rope_theta=500000.0,
    norm="rmsnorm",
    activation="silu",
)
