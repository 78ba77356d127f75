"""Models: the paper's DeltaGRU / DeltaLSTM networks (``gru_rnn``), the
RWKV6 and RG-LRU blocks, and the LM zoo's substrate: norms, RoPE and
embeddings (``common``), GQA/MQA, local and cross-attention with a ring KV
cache (``attention``), latent attention with a compressed cache (``mla``),
gated FFNs (``ffn``), mixture-of-experts (``moe``), block schedules
(``blocks``) and the language models, decoder-only, VLM and
encoder-decoder (``lm``)."""
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import make_schedule
from repro_torch.models.lm import (init_lm, init_lm_caches, lm_decode,
                                   lm_forward, lm_params_from_numpy,
                                   lm_prefill)
from repro_torch.models.mla import MlaCache

__all__ = ["KVCache", "MlaCache", "make_schedule", "init_lm",
           "init_lm_caches", "lm_forward", "lm_prefill", "lm_decode",
           "lm_params_from_numpy"]
