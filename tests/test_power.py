"""PowerSpectrum: spline, Romberg sigma(R), normalization, tables."""

import math
from pathlib import Path

import numpy as np
import pytest
from scipy import integrate

from zeldovich.utils.params import Parameters
from zeldovich.utils.power import PowerSpectrum, mode_amplitude_tables, romberg

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def make_params(**over):
    d = dict(
        BoxSize=720.0,
        NP=64**3,
        CPD=375,
        ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/ic",
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


def test_romberg_vs_scipy():
    val, prec = romberg(lambda x: math.sin(x) ** 2 * math.exp(-x), 0.0, 10.0, 1e-10)
    want, _ = integrate.quad(lambda x: math.sin(x) ** 2 * math.exp(-x), 0, 10)
    assert val == pytest.approx(want, rel=1e-9)


def test_sigma8_normalization():
    p = make_params()
    Pk = PowerSpectrum(p)
    # After normalization, sigma(Pk_norm) must equal Pk_sigma (up to the
    # box-volume factor applied afterwards): power carries 1/V_box, and
    # sigmaR integrates P, so sigma picks up V^-1/2.
    got = Pk.sigmaR(8.0) * p.boxsize**1.5
    assert got == pytest.approx(0.0210839935761, rel=1e-6)


def test_sigma_vs_scipy_quad():
    p = make_params()
    Pk = PowerSpectrum(p)
    R = 8.0

    def integrand(k):
        x = k * R
        w = 3.0 * (math.sin(x) - x * math.cos(x)) / x**3 if x > 1e-3 else 1 - x * x / 10
        return 0.5 / math.pi**2 * k * k * w * w * Pk.power(k)

    want, _ = integrate.quad(integrand, 0, 10, limit=200)
    assert Pk.sigmaR(R) ** 2 == pytest.approx(want, rel=1e-5)


def test_powerlaw_analytic_sigma():
    p = make_params(
        ZD_Pk_filename="", ZD_Pk_powerlaw_index=-1.0, ZD_Pk_sigma=1.0
    )
    Pk = PowerSpectrum(p)
    assert Pk.is_powerlaw
    # Normalization makes sigma(Pk_norm)^2 * V = Pk_sigma^2
    got = Pk.sigmaR(8.0) * p.boxsize**1.5
    assert got == pytest.approx(1.0, rel=1e-12)


def test_power_vec_matches_scalar():
    p = make_params(ZD_Pk_smooth=2.0)
    Pk = PowerSpectrum(p)
    ks = np.array([0.0, 1e-4, 1e-2, 0.1, 0.5, 1.0, 2.0])
    vec = Pk.power_vec(ks)
    for k, v in zip(ks, vec):
        assert v == Pk.power(float(k)), k


def test_smoothing_factor():
    p0 = make_params()
    ps = make_params(ZD_Pk_smooth=3.0)
    a = PowerSpectrum(p0)
    b = PowerSpectrum(ps)
    k = 0.7
    assert b.power(k) / a.power(k) == pytest.approx(math.exp(-k * k * 9.0), rel=1e-12)


def test_white_noise_flat():
    p = make_params(
        ZD_Pk_filename=str(ASSETS / "white_noise.pow"),
        ZD_Pk_norm=0.0,
        ZD_Pk_sigma=1.0,
    )
    Pk = PowerSpectrum(p)
    # No renormalization (Pk_norm == 0); power = 1/V everywhere in range
    for k in (1e-3, 1e-2, 0.1, 1.0, 10.0):
        assert Pk.power(k) == pytest.approx(1.0 / p.boxsize**3, rel=1e-6)


def test_infer_Tk_unity_on_large_scales():
    p = make_params()
    Pk = PowerSpectrum(p)
    assert Pk.infer_Tk(Pk.kmin) == pytest.approx(1.0, rel=1e-12)
    # T(k) should fall below 1 on small scales for a CDM-like spectrum
    assert Pk.infer_Tk(1.0) < 1.0


def test_mode_amplitude_tables():
    p = make_params()
    Pk = PowerSpectrum(p)
    pk_tab, M_tab = mode_amplitude_tables(Pk, p)
    half = p.ppd // 2
    assert len(pk_tab) == 3 * half * half + 1
    n2 = 14
    kmag = math.sqrt(n2) * p.fundamental
    assert pk_tab[n2] == pytest.approx(Pk.power(kmag), rel=1e-14)
    assert pk_tab[0] == 0.0
    growth = 1.0 / (1 + p.z_initial)
    M14 = (
        2.0 * growth * 299792.458**2 * Pk.infer_Tk(kmag) * kmag**2
        / (3.0 * p.Omega_M * 100.0**2)
    )
    assert M_tab[n2] == pytest.approx(M14, rel=1e-12)


def test_sigma_ratio_normalization():
    """ZD_Pk_sigma_ratio scales the spectrum by ratio^2 (no sigma target)."""
    base = make_params()
    a = PowerSpectrum(base)
    scaled = make_params(ZD_Pk_sigma=0.0, ZD_Pk_sigma_ratio=0.5)
    b = PowerSpectrum(scaled)
    # power ratio = (0.5 / (sigma_target/sigma_input))^2 relative to a
    k = 0.3
    input_sigma = 0.0781753  # printed by the reference for this spectrum
    expect = (0.5 / (0.0210839935761 / input_sigma)) ** 2
    assert b.power(k) / a.power(k) == pytest.approx(expect, rel=1e-4)


def test_pk_scale_wavenumber_conversion():
    """ZD_Pk_scale rescales input-file wavenumbers before fitting."""
    a = PowerSpectrum(make_params(ZD_Pk_norm=0.0, ZD_Pk_sigma=1.0))
    b = PowerSpectrum(
        make_params(ZD_Pk_norm=0.0, ZD_Pk_sigma=1.0, ZD_Pk_scale=2.0)
    )
    # P_b(k) = P_a(k / 2) (same table, wavenumbers doubled)
    assert b.power(0.4) == pytest.approx(a.power(0.2), rel=1e-12)
