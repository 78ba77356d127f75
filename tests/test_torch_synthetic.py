"""The port's synthetic datasets (``repro_torch.data.synthetic``) against the
JAX package's, on the CPU.

``jax.random`` streams cannot be matched bit for bit, so each generator is
split into its random draws and a deterministic build. The tests feed the
build the JAX function's own draws (``jax.random`` called as
``repro/data/synthetic.py`` calls it, with the same key splits) and compare
the batch with ``digit_batch(key)`` / ``gas_batch(key)`` of the JAX package:
integers exactly; features within a few float32 ulps of their magnitude
(``sin`` / ``exp`` / ``pow`` and the sums over digits and over time are the
libraries' own).
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)


def _jax_digit_draws(key, batch, max_t, max_l):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    n = jsyn.N_FEATS
    draws = {
        "lab_lens": jax.random.randint(k1, (batch,), 1, max_l + 1),
        "labels": jax.random.randint(k2, (batch, max_l), 0,
                                     jsyn.N_DIGIT_CLASSES),
        "dur": jax.random.randint(k3, (batch, max_l), 8, 13),
        "noise": jax.random.normal(k4, (batch, max_t, n)),
        "floor": jax.random.normal(k5, (batch, 1, n)),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _jax_gas_draws(key, batch, t_len):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    n = jsyn.N_SENSORS
    draws = {
        "eps": jax.random.normal(k1, (t_len, batch)),
        "c0": jax.random.normal(k2, (batch,)),
        "a": jax.random.uniform(k3, (n,)),
        "p": jax.random.uniform(jax.random.fold_in(k3, 1), (n,)),
        "drift": jax.random.normal(k4, (t_len, batch, n)),
        "noise": jax.random.normal(jax.random.fold_in(k4, 1),
                                   (t_len, batch, n)),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("seed,batch,max_t,max_l",
                         [(11, 32, 96, 7), (3, 5, 40, 3)])
def test_digit_build_matches_jax(seed, batch, max_t, max_l):
    key = jax.random.PRNGKey(seed)
    want = jsyn.digit_batch(key, batch=batch, max_t=max_t, max_l=max_l)
    got = tsyn.digit_build(_jax_digit_draws(key, batch, max_t, max_l),
                           device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("labels", "in_lens", "lab_lens"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    f = np.asarray(want["features"])
    assert got["features"].shape == f.shape == (max_t, batch, jsyn.N_FEATS)
    # two formant bumps (exp) of a sin-shaped trajectory, summed over at
    # most max_l digits, plus noise: a few ulps of the features' scale (7.9
    # measured)
    np.testing.assert_allclose(got["features"].numpy(), f, rtol=0,
                               atol=16 * 2.0 ** -24 * np.abs(f).max())


@pytest.mark.parametrize("seed,batch,t_len", [(0, 16, 128), (5, 3, 64)])
def test_gas_build_matches_jax(seed, batch, t_len):
    key = jax.random.PRNGKey(seed)
    want = jsyn.gas_batch(key, batch=batch, t_len=t_len)
    got = tsyn.gas_build(_jax_gas_draws(key, batch, t_len), device="cpu")
    assert sorted(got) == sorted(want)
    # the OU path: the same recursion in the same order, step by step; XLA
    # may contract its multiply-adds, so a few ulps over 128 steps (2.1
    # measured)
    t = np.asarray(want["targets"])
    np.testing.assert_allclose(got["targets"].numpy(), t, rtol=0,
                               atol=16 * 2.0 ** -24 * np.abs(t).max())
    # the responses add pow() of the path and a cumulative sum of drift over
    # time, each summed in the library's own order (3.0 ulps measured)
    f = np.asarray(want["features"])
    assert got["features"].shape == f.shape == (t_len, batch, jsyn.N_SENSORS)
    np.testing.assert_allclose(got["features"].numpy(), f, rtol=0,
                               atol=16 * 2.0 ** -24 * np.abs(f).max())


def test_port_batches_are_seeded_and_well_formed():
    a = tsyn.digit_batch(7, batch=6, max_t=64, device="cpu")
    b = tsyn.digit_batch(torch.Generator().manual_seed(7), batch=6, max_t=64,
                         device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["features"].shape == (64, 6, tsyn.N_FEATS)
    assert a["features"].dtype == torch.float32
    lab, lens = a["labels"], a["lab_lens"]
    assert ((lens >= 1) & (lens <= 7)).all()
    assert ((lab >= 1) & (lab <= tsyn.N_DIGIT_CLASSES)).all()  # 0 = blank
    # every label sequence fits its input (CTC needs one frame a label)
    assert (a["in_lens"] >= lens).all() and (a["in_lens"] <= 64).all()
    g = tsyn.gas_batch(7, batch=4, t_len=50, device="cpu")
    assert g["features"].shape == (50, 4, tsyn.N_SENSORS)
    assert g["targets"].shape == (50, 4, 1) and (g["targets"] >= 0).all()
    # temporally smooth, so deltas are sparse: a frame moves far less than
    # the features' spread
    f = g["features"]
    assert float((f[1:] - f[:-1]).abs().mean()) < 0.2 * float(f.std())


def test_batch_stream_draws_fresh_batches():
    stream = tsyn.batch_stream(tsyn.gas_batch, 3, batch=2, t_len=16,
                               device="cpu")
    first, second = next(stream), next(stream)
    assert not torch.equal(first["features"], second["features"])
    again = next(tsyn.batch_stream(tsyn.gas_batch, 3, batch=2, t_len=16,
                                   device="cpu"))
    assert torch.equal(first["features"], again["features"])
