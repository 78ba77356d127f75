"""rwkv6-1.6b [ssm] — "Finch": attention-free, data-dependent decay,
token-shift; head_dim 64 gives 32 heads. The PyTorch port of
:mod:`repro.configs.rwkv6_1_6b` [arXiv:2404.05892; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                # d_model / 64
    n_kv_heads=32,
    d_ff=7168,                 # channel-mix width (3.5x)
    vocab=65536,
    head_dim=64,
    rwkv=True,
    block_pattern=("rwkv",),
    norm="layernorm",
    rope_theta=10000.0,        # unused (attention-free)
    activation="relu_sq",
)


def reduced_delta_recipe(generator, output_size: int = 48, device=None):
    """The compile-ready delta-RWKV6 serving triple at the reduced size.

    Returns ``(cfg, model, task)``: :meth:`ModelConfig.reduced` with
    ``delta_decode=True``, an
    :func:`repro_torch.core.deltarwkv.init_deltarwkv_model` dict sized off
    it, drawn from ``generator`` (a ``torch.Generator`` or an int seed) and
    placed on ``device`` (default ``"cuda"``; compile it with
    ``compile_delta_program(model, cell="rwkv6")``), and the matching
    ``GruTaskConfig`` for ``DeltaStreamEngine``.
    """
    from repro_torch.core.deltarwkv import init_deltarwkv_model
    from repro_torch.models.gru_rnn import GruTaskConfig

    cfg = CONFIG.reduced(delta_decode=True)
    model = init_deltarwkv_model(generator, cfg.d_model, cfg.n_layers,
                                 output_size, device=device)
    task = GruTaskConfig(input_size=cfg.d_model, hidden_size=cfg.d_model,
                         num_layers=cfg.n_layers, output_size=output_size)
    return cfg, model, task
