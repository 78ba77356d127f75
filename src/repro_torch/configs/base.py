"""The model and shape configuration dataclasses of the architecture
configs, the PyTorch port of :mod:`repro.configs.base` (plain dataclasses;
the port keeps its own copy)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np
    activation: str = "silu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # layer pattern: repeated period of block kinds; "attn" is a standard
    # decoder block; see models/blocks.py BLOCK_KINDS.
    block_pattern: tuple = ("attn",)
    attn_window: Optional[int] = None        # local attention window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # MLA (DeepSeek)
    use_mla: bool = False
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    # VLM (cross-attention image layers)
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    vision_dim: int = 0            # stub frontend embedding dim
    # enc-dec (audio)
    encdec: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 0
    audio_dim: int = 0             # stub frontend feature dim
    # RWKV
    rwkv: bool = False
    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "full"            # full | none
    # the paper's technique on this arch (DESIGN.md §4/§5)
    delta_decode: bool = False
    theta_x: float = 0.0
    theta_h: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (attention-free or windowed only)."""
        kinds = set(self.block_pattern)
        full_attn = ("attn" in kinds or "cross" in kinds or self.encdec
                     or self.use_mla)
        return not full_attn

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=len(self.block_pattern) if len(self.block_pattern) > 1 else 2,
            d_model=64, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16, d_ff=128, vocab=128,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_d_ff=32 if self.n_experts else 0,
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            kv_lora=32, qk_nope=16, qk_rope=8, v_head_dim=16,
            n_image_tokens=8 if self.n_image_tokens else 0,
            vision_dim=32 if self.vision_dim else 0,
            cross_attn_every=self.cross_attn_every and 2,
            n_encoder_layers=2 if self.encdec else 0,
            n_audio_frames=16 if self.encdec else 0,
            audio_dim=8 if self.audio_dim else 0,
            attn_window=16 if self.attn_window else None,
            dtype="float32", remat="none",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
