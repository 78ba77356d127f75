"""The paper's own networks: multi-layer (Delta)GRU stacks with a CTC
classifier head (TIDIGITS) or a regression head (SensorsGas). The PyTorch
port of :mod:`repro.models.gru_rnn`.

A model is a dict ``{"gru": [GruLayerParams, ...], "head": [H, O],
"head_b": [O]}`` of tensors on one device (``"lstm"`` and
``LstmLayerParams`` for the LSTM twin; the delta-ized LM cells build theirs
with :func:`repro_torch.core.deltarwkv.init_deltarwkv_model` and
:func:`repro_torch.core.deltarglru.init_deltarglru_model`). :func:`init_gru_model` /
:func:`init_lstm_model` draw one from a seeded ``torch.Generator``;
:func:`model_from_numpy` carries the JAX package's model (as numpy arrays)
across, so both packages compute from the same weights.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.deltagru import (GruLayerParams, deltagru_sequence,
                                       gru_sequence, init_gru_stack)
from repro_torch.core.deltalstm import LstmLayerParams, init_lstm_stack
from repro_torch.core.deltarglru import RglruLayerParams
from repro_torch.core.deltarwkv import RwkvLayerParams
from repro_torch.core.program import infer_cell
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.common import dense_init
from repro_torch.quant.qat import FP32, QatPolicy


@dataclass(frozen=True)
class GruTaskConfig:
    input_size: int
    hidden_size: int
    num_layers: int
    output_size: int          # CTC classes (incl. blank) or regression dims
    task: str = "ctc"         # ctc | regression
    theta_x: float = 0.0
    theta_h: float = 0.0


# Paper network sizes (Table II) on TIDIGITS features (40-d log filter bank).
PAPER_NETWORKS = {
    "1L-256H": GruTaskConfig(40, 256, 1, 12),
    "2L-256H": GruTaskConfig(40, 256, 2, 12),
    "1L-512H": GruTaskConfig(40, 512, 1, 12),
    "2L-512H": GruTaskConfig(40, 512, 2, 12),
    "1L-768H": GruTaskConfig(40, 768, 1, 12),
    "2L-768H": GruTaskConfig(40, 768, 2, 12),
    # SensorsGas regression (14 sensors -> 1 concentration)
    "2L-256H-GAS": GruTaskConfig(14, 256, 2, 1, task="regression"),
    # AMPRO prosthetic control network (Fig. 15)
    "2L-128H-AMPRO": GruTaskConfig(8, 128, 2, 4, task="regression"),
}


def _init_model(cell: str, init_stack, generator, cfg: GruTaskConfig,
                dtype, device) -> dict:
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    stack = init_stack(generator, cfg.input_size, cfg.hidden_size,
                       cfg.num_layers, dtype)
    head = dense_init(generator, cfg.hidden_size, cfg.output_size, dtype)
    return {cell: [p.to(dev) for p in stack], "head": head.to(dev),
            "head_b": torch.zeros((cfg.output_size,), dtype=dtype,
                                  device=dev)}


def init_gru_model(generator, cfg: GruTaskConfig, dtype=torch.float32,
                   device=None) -> dict:
    """Random model from a ``torch.Generator`` (or an int seed): Glorot
    GRU weights, zero biases, a truncated-normal head. Drawn on the CPU and
    moved to ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``). The numbers differ from the JAX package's for the
    same seed; use :func:`model_from_numpy` to share weights."""
    return _init_model("gru", init_gru_stack, generator, cfg, dtype, device)


def init_lstm_model(generator, cfg: GruTaskConfig, dtype=torch.float32,
                    device=None) -> dict:
    """The LSTM twin of :func:`init_gru_model` (the paper's Table VII
    workload family): a DeltaLSTM stack (forget-gate bias 1) under the same
    task config and head shapes, as ``{"lstm", "head", "head_b"}``. Compile
    it with ``compile_delta_program(model, cell="lstm", ...)`` and serve it
    through ``DeltaStreamEngine`` like the GRU models. Same device rule as
    :func:`init_gru_model`."""
    return _init_model("lstm", init_lstm_stack, generator, cfg, dtype,
                       device)


def model_from_numpy(tree: dict, device=None) -> dict:
    """The port's model from a model dict of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, init_gru_model(key, cfg))`` of the
    JAX package. The stack key names the cell: ``"gru"`` or ``"lstm"``
    layers are ``(w_x, w_h, b)`` triples; ``"rwkv6"`` and ``"rglru"`` layers
    are the JAX package's layer NamedTuples (``init_deltarwkv_model``,
    ``init_deltarglru_model``), matched field by field, or its models-module
    dicts (``init_rwkv_time_mix``, ``init_rglru_block``, where the RG-LRU
    ``lam`` field is spelled ``"lambda"``). Values are copied bit for bit
    (as float32) onto ``device`` (default ``"cuda"``; raises without a card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cell = infer_cell(tree)
    layer = {"gru": GruLayerParams, "lstm": LstmLayerParams,
             "rwkv6": RwkvLayerParams, "rglru": RglruLayerParams}[cell]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def fields(p) -> dict:
        if isinstance(p, dict):
            return {("lam" if k == "lambda" else k): v for k, v in p.items()}
        if hasattr(p, "_fields"):
            return p._asdict()
        return dict(zip(layer._fields, p))

    stack = []
    for p in tree[cell]:
        f = fields(p)
        stack.append(layer(**{name: t(f[name]) for name in layer._fields}))
    return {cell: stack, "head": t(tree["head"]),
            "head_b": t(tree["head_b"])}


def gru_model_forward(params, cfg: GruTaskConfig, xs: torch.Tensor, *,
                      use_delta: bool = True, qat: QatPolicy = FP32,
                      collect_sparsity: bool = False,
                      backend: str | None = None,
                      layouts=None,
                      program=None):
    """``xs: [T, B, I]`` -> (outputs ``[T, B, O]``, sparsity stats dict).

    ``use_delta=False`` runs the plain-GRU oracle. ``program=`` (a
    :func:`repro_torch.core.program.compile_deltagru` result) runs the
    compiled delta path with its packed weights and head (or
    ``params``'s head, for a program compiled from a bare stack); the
    ``backend=`` / ``layouts=`` kwargs are the ad-hoc spelling.

    ``qat=`` (training-time fake quant, e.g.
    :data:`repro_torch.quant.qat.EDGEDRNN_QAT`) fake-quantizes every
    layer's ``w_x``, ``w_h`` and ``b`` and runs the LUT activations, so it
    needs the ``dense`` backend (the kernel backends raise). Train with it,
    then export with :func:`repro_torch.quant.export.quantize_delta_model`
    and run the returned ``fused_q8`` program: the two sides of the
    paper's recipe.
    """
    if program is not None:
        if backend is not None or layouts is not None:
            raise ValueError(
                "backend=/layouts= conflict with program= — the compiled "
                f"program already fixes both (its backend: "
                f"{program.backend!r}); drop the legacy kwargs")
        if qat.enabled:
            raise ValueError(
                "program= holds weights packed at compile time; QAT fake "
                "quant would be silently ignored — quantize at compile "
                "(backend='fused_q8') or run the legacy dense path")
        if not use_delta:
            raise ValueError("program= compiles the DeltaGRU path; use the "
                             "legacy kwargs for the plain-GRU oracle")
        ys, _, stats = program.sequence(xs, cfg.theta_x, cfg.theta_h,
                                        collect_sparsity=collect_sparsity)
        if program.head is not None:
            return program.apply_head(ys), stats
        return ys @ params["head"] + params["head_b"], stats
    gru_params = [qat.quantize_params(p) for p in params["gru"]]
    sigmoid, tanh = qat.act_fns()
    stats = {}
    if use_delta:
        ys, _, stats = deltagru_sequence(
            gru_params, xs, cfg.theta_x, cfg.theta_h,
            collect_sparsity=collect_sparsity, backend=backend or "dense",
            layouts=layouts, sigmoid=sigmoid, tanh=tanh)
    else:
        ys = gru_sequence(gru_params, xs, sigmoid, tanh)
    return ys @ params["head"] + params["head_b"], stats
