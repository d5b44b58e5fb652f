"""Physics validation: the generated field's statistics match the input P(k)."""

from pathlib import Path

import numpy as np
import pytest

from zeldovich.models.pipeline import Zeldovich
from zeldovich.utils.params import Parameters
from zeldovich.utils.power import PowerSpectrum

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def make_params(ppd=32, **over):
    d = dict(
        BoxSize=720.0,
        NP=ppd**3,
        CPD=ppd,
        ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/icphys",
        InitialRedshift=49.0,
        ZD_Seed=12346,
        ZD_NumBlock=2,
        ZD_Pk_scale=1.0,
        ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.0210839935761,
        ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
        ZD_Version=2,
    )
    d.update(over)
    return Parameters.from_dict(d)


def measure_power(delta, boxsize):
    """Measured P(k) of a real field, binned by |k| (forward-FFT/V norm)."""
    n = delta.shape[0]
    dk = np.fft.fftn(delta) / n**3
    pk = np.abs(dk) ** 2 * boxsize**3
    kidx = np.fft.fftfreq(n, d=1.0 / n)
    KX, KY, KZ = np.meshgrid(kidx, kidx, kidx, indexing="ij")
    kmag = np.sqrt(KX**2 + KY**2 + KZ**2) * 2 * np.pi / boxsize
    return kmag.ravel(), pk.ravel()


def test_measured_power_matches_input():
    """Binned P(k) of the output density equals the (normalized) input
    spectrum within sample variance."""
    param = make_params(ppd=32)
    model = Zeldovich(param)
    x = np.asarray(model.xspace())
    delta = x[0].real
    kmag, pk = measure_power(delta, param.boxsize)

    Pk = PowerSpectrum(param)
    # bin in k, compare to V * power(k) (power() carries 1/V)
    sel = (kmag > 0) & (kmag < 0.8 * param.nyquist)
    kk, pp = kmag[sel], pk[sel]
    bins = np.linspace(kk.min(), kk.max(), 12)
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = (kk >= lo) & (kk < hi)
        nmodes = m.sum()
        if nmodes < 50:
            continue
        kmid = kk[m].mean()
        want = Pk.power(kmid) * param.boxsize**3
        got = pp[m].mean()
        # delta(k) per-mode |D|^2 is exponentially distributed; the binned
        # mean has ~1/sqrt(nmodes/2) scatter, plus P(k) curvature in the bin
        tol = 6.0 / np.sqrt(nmodes / 2) + 0.25
        assert got == pytest.approx(want, rel=tol), (kmid, nmodes)


def test_displacement_consistency():
    """q(k) = i k delta(k)/k^2: check via the divergence in k-space."""
    param = make_params(ppd=16)
    x = np.asarray(Zeldovich(param).xspace())
    n = param.ppd
    delta = x[0].real
    qx, qy, qz = x[0].imag, x[1].real, x[1].imag
    dk = np.fft.fftn(delta)
    qxk, qyk, qzk = (np.fft.fftn(q) for q in (qx, qy, qz))
    kidx = np.fft.fftfreq(n, d=1.0 / n)
    # mind the axis order: arrays are [y, z, x]
    KY, KZ, KX = np.meshgrid(kidx, kidx, kidx, indexing="ij")
    k2 = (KX**2 + KY**2 + KZ**2) * param.fundamental**2
    mask = k2 > 0
    # q(k) = i k delta(k) / k^2  =>  i k . q(k) = -delta(k)
    lhs = 1j * param.fundamental * (KX * qxk + KY * qyk + KZ * qzk)
    np.testing.assert_allclose(
        lhs[mask], -dk[mask], atol=1e-9 * np.abs(dk).max()
    )


def test_fixed_amplitude_power():
    """qPk_fix_to_mean: every surviving mode has |D|^2 exactly P(k)/V."""
    param = make_params(ppd=16, ZD_qPk_fix_to_mean=1)
    model = Zeldovich(param)
    G = np.asarray(model.kspace())
    n = param.ppd
    A = G[0]
    refl = np.conj(
        A[(-np.arange(n)) % n][:, (-np.arange(n)) % n][:, :, (-np.arange(n)) % n]
    )
    D = 0.5 * (A + refl)
    Pk = PowerSpectrum(param)
    kidx = np.fft.fftfreq(n, d=1.0 / n)
    KY, KZ, KX = np.meshgrid(kidx, kidx, kidx, indexing="ij")
    kmag = np.sqrt(KX**2 + KY**2 + KZ**2) * param.fundamental
    nz = np.abs(D) > 0
    want = np.vectorize(Pk.power)(kmag[nz])
    np.testing.assert_allclose(np.abs(D[nz]) ** 2, want, rtol=1e-10)
