"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1
attention (38 layers = 12x(rec,rec,attn) + (rec,rec)), MQA kv=1, window
2048. The PyTorch port of :mod:`repro.configs.recurrentgemma_9b`
[arXiv:2402.19427; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,              # MQA
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    attn_window=2048,
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="gelu_tanh",
)


def reduced_delta_recipe(generator, output_size: int = 48, device=None):
    """The compile-ready delta-RG-LRU serving triple at the reduced size.

    Returns ``(cfg, model, task)``: :meth:`ModelConfig.reduced` with
    ``delta_decode=True``, an
    :func:`repro_torch.core.deltarglru.init_deltarglru_model` dict for the
    RECURRENT layers of the reduced block pattern (attention layers are not
    delta targets), drawn from ``generator`` (a ``torch.Generator`` or an
    int seed) and placed on ``device`` (default ``"cuda"``), and the
    matching ``GruTaskConfig`` for ``DeltaStreamEngine``.
    """
    from repro_torch.core.deltarglru import init_deltarglru_model
    from repro_torch.models.gru_rnn import GruTaskConfig

    cfg = CONFIG.reduced(delta_decode=True)
    pattern = cfg.block_pattern
    n_rec = sum(pattern[i % len(pattern)] == "rglru"
                for i in range(cfg.n_layers))
    model = init_deltarglru_model(generator, cfg.d_model, n_rec, output_size,
                                  device=device)
    task = GruTaskConfig(input_size=cfg.d_model, hidden_size=cfg.d_model,
                         num_layers=n_rec, output_size=output_size)
    return cfg, model, task
