"""The perf model's accelerator section of the PyTorch port
(``repro_torch/core/perf_model.py``: ``GpuChipSpec``, ``H100``,
``gpu_batch1_gru_roofline``, ``batch_sweep``) against the JAX package's
(``TpuChipSpec``, ``tpu_batch1_gru_roofline``, ``batch_sweep``).

The law is the same and only the constants differ, so given a
``GpuChipSpec`` built from the reference's chip fields the port's dicts
equal the reference's exactly (``==``, float for float) over dims x gamma
x batch.
"""
import itertools

import pytest

from repro.core import perf_model as jpm
from repro.core.sparsity import GruDims as JDims
from repro_torch.core import perf_model as tpm
from repro_torch.core.sparsity import GruDims as TDims

DIMS = ((40, 768, 2), (16, 64, 2), (14, 256, 2))
GAMMAS = (0.0, 0.5, 0.9)
BATCHES = (1, 8, 256)


def _same_chip():
    ref = jpm.V5E
    return tpm.GpuChipSpec(peak_bf16_flops=ref.peak_bf16_flops,
                           hbm_bw=ref.hbm_bw, nvlink_bw=ref.ici_bw)


@pytest.mark.parametrize("dims,gamma,batch",
                         list(itertools.product(DIMS, GAMMAS, BATCHES)))
def test_roofline_and_sweep_equal_the_reference(dims, gamma, batch):
    chip = _same_chip()
    for wbytes in (1, 2, 4):
        got = tpm.gpu_batch1_gru_roofline(TDims(*dims), gamma, batch=batch,
                                          weight_bytes=wbytes, chip=chip)
        want = jpm.tpu_batch1_gru_roofline(JDims(*dims), gamma, batch=batch,
                                           weight_bytes=wbytes,
                                           chip=jpm.V5E)
        assert got == want
    got = tpm.batch_sweep(TDims(*dims), [batch, 2 * batch], chip=chip,
                          gamma_eff=gamma)
    want = jpm.batch_sweep(JDims(*dims), [batch, 2 * batch], chip=jpm.V5E,
                           gamma_eff=gamma)
    assert got == want


def test_h100_is_the_data_sheet_and_the_default():
    """Dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 900 GB/s (H100 SXM
    data sheet), and the default chip of both functions."""
    assert tpm.H100 == tpm.GpuChipSpec(989e12, 3.35e12, 900e9)
    dims = TDims(40, 768, 2)
    assert tpm.gpu_batch1_gru_roofline(dims, 0.5) == \
        tpm.gpu_batch1_gru_roofline(dims, 0.5, chip=tpm.H100)
    assert tpm.batch_sweep(dims, [1, 4]) == tpm.batch_sweep(
        dims, [1, 4], chip=tpm.H100)
    # 2L-768H at batch 1 is memory-bound on the card, by the weights
    roof = tpm.gpu_batch1_gru_roofline(dims, 0.0)
    assert roof["bound"] == "memory"
    assert roof["t_memory"] == dims.n_params * 2 / 3.35e12
