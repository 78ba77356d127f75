"""Data substrate: synthetic TIDIGITS-like / SensorsGas-like generators
(nothing is downloaded), LM token streams with the modality stubs
(``lm_data``), and a prefetching host pipeline with mesh placement
(``pipeline``)."""
from repro_torch.data.lm_data import lm_batch, lm_batch_stream, token_batch
from repro_torch.data.pipeline import (Prefetcher, prefetch_to_mesh,
                                       shard_batch)

__all__ = ["lm_batch", "lm_batch_stream", "token_batch", "Prefetcher",
           "shard_batch", "prefetch_to_mesh"]
