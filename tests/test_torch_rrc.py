"""Port RRC (opticalimageprocessor_tpu_torch.ops.rrc) against the float64
oracle and the JAX package's kernel: byte-exact on full uint16 sweeps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu.ops import rrc as jrrc
from opticalimageprocessor_tpu_torch.ops import rrc

torch.set_num_threads(2)


def _port(src, k, b):
    return rrc.rrc_apply(
        torch.from_numpy(src), torch.from_numpy(np.asarray(k, np.float64)),
        torch.from_numpy(np.asarray(b, np.float64)),
    ).numpy()


@pytest.mark.parametrize(
    "k,b",
    [
        (1.0, 0.0),
        (0.5, 0.5),
        (2.0, -65536.0),
        (0.9987654321, 12.3456789),
        (1.0123456789, -17.25),
        (3.14159265358979, -100000.5),
        (-0.75, 30000.0),        # negative gain -> negative values wrap
        (1e-9, 0.999999999),
        (70000.0, 0.0),          # overflow wrap far beyond uint16
    ],
)
def test_rrc_full_sweep_exact(k, b):
    src = np.arange(65536, dtype=np.uint16)[None, :]
    kk = np.full(65536, k)
    bb = np.full(65536, b)
    np.testing.assert_array_equal(
        _port(src, kk, bb), cv_exact.rrc_exact(src, kk, bb)
    )


def test_rrc_random_params_full_sweep(rng):
    cols = 65536
    src = np.tile(np.arange(cols, dtype=np.uint16)[None, :], (4, 1))
    rng.shuffle(src.T)
    k = 0.9 + 0.2 * rng.random(cols)
    b = rng.normal(0, 50, cols)
    np.testing.assert_array_equal(
        _port(src, k, b), cv_exact.rrc_exact(src, k, b)
    )


def test_rrc_out_of_int32_range_is_zero():
    # |k*s + b| >= 2^31 and NaN give x86 cvttsd2si's 0x80000000 -> 0
    src = np.array([[0, 1, 2, 65535]], np.uint16)
    k = np.array([1.0, 2.0**31, np.nan, -(2.0**31)])
    b = np.array([2.0**31, 0.0, 0.0, 0.0])
    got = _port(src, k, b)
    np.testing.assert_array_equal(got, cv_exact.rrc_exact(src, k, b))
    np.testing.assert_array_equal(got, [[0, 0, 0, 0]])


def test_rrc_matches_jax_pallas_interpret(rng):
    src = rng.integers(0, 65536, size=(48, 256), dtype=np.uint16)
    k = 0.95 + 0.1 * rng.random(256)
    b = rng.normal(0, 20, 256)
    want = np.asarray(
        jrrc.rrc_apply(
            jnp.asarray(src), jnp.asarray(jrrc.split_rrc_params(k, b)),
            use_pallas=True, interpret=True,
        )
    )
    np.testing.assert_array_equal(_port(src, k, b), want)


def test_rrc_batched_strided_view_matches_per_band(rng):
    """A (bands, rows, cols) window of a larger strip (the registration's
    inline tile RRC) equals correcting each band's copy on its own."""
    strip = rng.integers(0, 65536, size=(4, 64, 96), dtype=np.uint16)
    k = 0.98 + 0.04 * rng.random((4, 96))
    b = rng.normal(0, 20, (4, 96))
    view = torch.from_numpy(strip)[:, 8:40, 16:80]
    got = rrc.rrc_apply(
        view, torch.from_numpy(k[:, 16:80]), torch.from_numpy(b[:, 16:80])
    ).numpy()
    for i in range(4):
        np.testing.assert_array_equal(
            got[i],
            cv_exact.rrc_exact(strip[i, 8:40, 16:80], k[i, 16:80],
                               b[i, 16:80]),
        )


def test_params_from_jax_split(rng):
    cols = 100_000
    k = 0.9 + 0.2 * rng.random(cols)
    b = rng.normal(0, 50, cols)
    k2, b2 = rrc.params_from_jax_split(jrrc.split_rrc_params(k, b))
    np.testing.assert_array_equal(k2, k)
    assert np.all(np.abs(b2 - b) <= 2.0**-47 * np.abs(b))
