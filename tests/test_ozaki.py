"""Ozaki-scheme int8 matmuls: f64-grade accuracy from integer products."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from zeldovich.ops import mmfft, ozaki

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def test_omatmul_matches_f64():
    rng = np.random.default_rng(0)
    for k, n in ((64, 48), (256, 256)):
        X = rng.normal(size=(3, 5, k)) * 10.0 ** rng.uniform(-6, 6)
        W = rng.normal(size=(k, n))
        want = X @ W
        got = np.asarray(ozaki.omatmul(jnp.asarray(X), ozaki.slice_static(W)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=1e-9 * scale, rtol=0)


def test_omatmul_zero_and_tiny():
    W = np.eye(8)
    X = jnp.zeros((4, 8), dtype=jnp.float64)
    got = np.asarray(ozaki.omatmul(X, ozaki.slice_static(W)))
    np.testing.assert_array_equal(got, 0.0)
    X = jnp.full((4, 8), 1e-200, dtype=jnp.float64)
    got = np.asarray(ozaki.omatmul(X, ozaki.slice_static(W)))
    np.testing.assert_allclose(got, 1e-200, rtol=1e-9)


@pytest.mark.parametrize("n", [16, 48, 1536])  # dense, dense, four-step
def test_cfft_ozaki_matches_numpy(n, monkeypatch):
    monkeypatch.setenv("ZT_OZAKI", "1")
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    re, im = mmfft.cfft_last(jnp.asarray(a.real), jnp.asarray(a.imag), -1)
    want = np.fft.fft(a, axis=-1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(
        np.asarray(re) + 1j * np.asarray(im), want, atol=1e-9 * scale, rtol=0
    )


@pytest.mark.slow  # ~8 s; test_chunked_matches_unchunked keeps ozaki in
# the fast tier
def test_half_pipeline_ozaki_parity(monkeypatch):
    """f64 half-spectrum pipeline with int8 matmuls == plain f64 (CPU)."""
    from zeldovich.models.pipeline import Zeldovich
    from zeldovich.utils.params import Parameters

    def params():
        # BoxSize unique to this test: a distinct SynthConfig, so the
        # ZT_OZAKI=1 trace cannot reuse a cached plain-f64 compilation of
        # the same jitted forward from another test in this process
        return Parameters.from_dict(
            dict(
                BoxSize=123.0,
                NP=16**3,
                CPD=16,
                ICFormat="RVZel",
                InitialConditionsDirectory="/tmp/ic_oz",
                InitialRedshift=49.0,
                ZD_Seed=777,
                ZD_NumBlock=2,
                ZD_Pk_scale=1.0,
                ZD_Pk_norm=8.0,
                ZD_Pk_sigma=0.02,
                ZD_Pk_smooth=0.0,
                ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
                ZD_Version=2,
            )
        )

    monkeypatch.setenv("ZT_OZAKI", "1")
    got = np.asarray(Zeldovich(params(), dtype=jnp.float64).xspace_half_pair())
    monkeypatch.delenv("ZT_OZAKI")
    want = np.asarray(Zeldovich(params(), dtype=jnp.float64).xspace())
    np.testing.assert_allclose(
        got[:, 0] + 1j * got[:, 1],
        want,
        atol=1e-9 * np.abs(want).max(),
        rtol=0,
    )


def test_omatmul_pair_matches_f64():
    """The two-float (no-f64) form matches f64 matmuls to ~2^-40."""
    rng = np.random.default_rng(5)
    for k, n in ((64, 48), (512, 512)):
        X = rng.normal(size=(3, k))
        Xh = X.astype(np.float32)
        Xl = (X - Xh.astype(np.float64)).astype(np.float32)
        W = rng.normal(size=(k, n))
        want = X @ W
        hi, lo = ozaki.omatmul_pair(
            (jnp.asarray(Xh), jnp.asarray(Xl)), ozaki.slice_static(W)
        )
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=3e-10 * scale, rtol=0)


def test_chunked_matches_unchunked(monkeypatch):
    """Row-chunked streaming (the 512^3 HBM guard) is numerically inert."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(9, 37, 64))
    W = rng.normal(size=(64, 48))
    ws = ozaki.slice_static(W)
    Xh = X.astype(np.float32)
    Xl = (X - Xh.astype(np.float64)).astype(np.float32)
    pair = (jnp.asarray(Xh), jnp.asarray(Xl))
    plain = ozaki.omatmul(jnp.asarray(X), ws)
    plain_p = ozaki.omatmul_pair(pair, ws)
    monkeypatch.setattr(ozaki, "CHUNK_ELEMS", 2048)  # force chunking
    chunked = ozaki.omatmul(jnp.asarray(X), ws)
    chunked_p = ozaki.omatmul_pair(pair, ws)
    # per-chunk dynamic scales shift which mantissa bits the limbs keep, so
    # results differ only at the dropped-tail level (~2^-36 of the scale)
    want = X @ W
    tol = 1e-9 * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(plain), atol=tol, rtol=0)
    got_p = np.asarray(chunked_p[0], np.float64) + np.asarray(chunked_p[1], np.float64)
    ref_p = np.asarray(plain_p[0], np.float64) + np.asarray(plain_p[1], np.float64)
    np.testing.assert_allclose(got_p, ref_p, atol=tol, rtol=0)
    np.testing.assert_allclose(got_p, want, atol=tol, rtol=0)


def test_ifft3_half_df64_matches_f64():
    """Pair transform of a half-spectrum == the f64 transform."""
    rng = np.random.default_rng(6)
    h = 8
    spm = rng.normal(size=(2, 2, 2, h + 1, 2 * h, 2 * h)).astype(np.float32)
    want = np.asarray(mmfft.ifft3_half_pair(jnp.asarray(spm).astype(jnp.float64)))
    got = np.asarray(mmfft.ifft3_half_df64(jnp.asarray(spm)))
    np.testing.assert_allclose(
        got, want, atol=1e-9 * np.abs(want).max(), rtol=0
    )


@pytest.mark.slow  # 49 s (CI fast-tier budget; ozaki half-pipeline
# parity keeps a fast-tier df64 check)
def test_df64_mixed_mode_parity():
    """--dtype df64: f32 draws + f64 transforms, <1e-6 displacement error."""
    from pathlib import Path

    from zeldovich.models.pipeline import Zeldovich
    from zeldovich.utils.params import Parameters

    def params(box):
        return Parameters.from_dict(
            dict(
                BoxSize=box,
                NP=32**3,
                CPD=32,
                ICFormat="RVZel",
                InitialConditionsDirectory="/tmp/ic_df64",
                InitialRedshift=49.0,
                ZD_Seed=12346,
                ZD_NumBlock=2,
                ZD_Pk_scale=1.0,
                ZD_Pk_norm=8.0,
                ZD_Pk_sigma=0.02,
                ZD_Pk_smooth=0.0,
                ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
                ZD_Version=2,
            )
        )

    got = np.asarray(Zeldovich(params(321.0), dtype=jnp.float32).xspace_half_df64())
    assert got.dtype == np.float64
    want = np.asarray(Zeldovich(params(321.0), dtype=jnp.float64).xspace())
    dsp_g = np.stack([got[0, 1], got[1, 0], got[1, 1]])
    dsp_w = np.stack([want[0].imag, want[1].real, want[1].imag])
    err = np.abs(dsp_g - dsp_w).max()
    assert err < 1e-6, f"df64 displacement error {err:.3e} >= 1e-6"


@pytest.mark.parametrize("k", [1, 17, 65, 68, 128])
def test_imatmul_exact_any_contraction(k):
    """int8 limb products are exact int32 sums for every contraction
    length, including those imatmul zero-pads to a multiple of 4."""
    rng = np.random.default_rng(k)
    a = rng.integers(-64, 65, size=(3, 5, k)).astype(np.int8)
    b = rng.integers(-64, 65, size=(k, 7)).astype(np.int8)
    got = np.asarray(ozaki.imatmul(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.int32 and got.shape == (3, 5, 7)
    want = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(got, want)
