"""seamless-m4t-large-v2 [audio] — enc-dec transformer backbone; the speech
frontend is a stub providing precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,               # decoder layers (self + cross + ffn)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    encdec=True,
    n_encoder_layers=24,
    n_audio_frames=1536,       # stub speech-frame stream length
    audio_dim=160,             # stub fbank-stack feature dim
    block_pattern=("cross",),  # standard transformer decoder layer
    rope_theta=10000.0,
    norm="layernorm",
    activation="relu",
)
