"""End-to-end pipeline tests: FFT convention, analytic one-mode wave,
white-noise variance, f_NL, output files, PART1/PART2 checkpointing."""

import math
from pathlib import Path

import numpy as np
import pytest

from reference_emulator import emulate_kgrid, inverse_fft3
from zeldovich.models.pipeline import Zeldovich
from zeldovich.utils.output import OutputWriter, read_particles, setup_output_dir
from zeldovich.utils.params import Parameters
from zeldovich.utils.power import PowerSpectrum

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def make_params(tmp_path, ppd=8, **over):
    d = dict(
        BoxSize=100.0,
        NP=ppd**3,
        CPD=ppd,  # one ic_ file per slab
        ICFormat="RVZel",
        InitialConditionsDirectory=str(tmp_path / "ic"),
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
    d.update(over)
    return Parameters.from_dict(d)


def test_xspace_matches_emulator_fft(tmp_path):
    param = make_params(tmp_path, ppd=8)
    model = Zeldovich(param)
    got = np.asarray(model.xspace())
    Pk = PowerSpectrum(param)
    want = inverse_fft3(emulate_kgrid(param, Pk))
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def test_displacements_are_real(tmp_path):
    param = make_params(tmp_path, ppd=12)
    x = np.asarray(Zeldovich(param).xspace())
    # Re A = density, Im A = q_x etc are each real fields; the packing means
    # x-space arrays are complex with both parts meaningful -- realness was
    # already checked at the k-level; here check the fields aren't NaN/huge
    assert np.all(np.isfinite(x))


def test_one_mode_analytic(tmp_path):
    """ZD_qonemode: a single plane wave with known displacement field."""
    kvec = (2, 1, -1)
    param = make_params(
        tmp_path, ppd=16, ZD_qonemode=1, ZD_one_mode=list(kvec)
    )
    model = Zeldovich(param)
    G = np.asarray(model.kspace())
    # exactly the chosen mode and its conjugate survive
    nz = np.argwhere(np.abs(G[0]) > 0)
    assert len(nz) == 2
    ppd = param.ppd
    kx, ky, kz = kvec
    assert (ky % ppd, kz % ppd, kx % ppd) in [tuple(i) for i in nz]
    assert ((-ky) % ppd, (-kz) % ppd, (-kx) % ppd) in [tuple(i) for i in nz]

    # unpack pure D from A = D + iF using the Hermitian mirror:
    # D = (A(k) + conj(A(-k)))/2, F = (A(k) - conj(A(-k)))/(2i)
    A_k = G[0][ky % ppd, kz % ppd, kx % ppd]
    A_mk = G[0][(-ky) % ppd, (-kz) % ppd, (-kx) % ppd]
    D = 0.5 * (A_k + np.conj(A_mk))
    F = (A_k - np.conj(A_mk)) / 2j
    fund = param.fundamental
    k2 = (kx**2 + ky**2 + kz**2) * fund**2
    np.testing.assert_allclose(F, 1j * kx * fund / k2 * D, rtol=1e-12)

    x = np.asarray(model.xspace())
    yy, zz, xx = np.meshgrid(*(np.arange(ppd),) * 3, indexing="ij")
    phase = 2 * np.pi / ppd * (kx * xx + ky * yy + kz * zz)
    delta_want = 2 * (D.real * np.cos(phase) - D.imag * np.sin(phase))
    np.testing.assert_allclose(
        x[0].real, delta_want, atol=1e-12 * np.abs(delta_want).max()
    )
    # displacement along x: q_x = Im A
    qx_want = 2 * np.real(F * np.exp(1j * phase))
    np.testing.assert_allclose(
        x[0].imag, qx_want, atol=1e-12 * max(np.abs(qx_want).max(), 1e-30)
    )


def test_white_noise_variance(tmp_path):
    """Flat P(k)=1 with no renormalization: each surviving mode is a complex
    Gaussian with per-part variance P/(2V); the density field variance is
    predicted by Parseval."""
    ppd = 32
    param = make_params(
        tmp_path,
        ppd=ppd,
        ZD_Pk_filename=str(ASSETS / "white_noise.pow"),
        ZD_Pk_norm=0.0,
        ZD_Pk_sigma=1.0,
        BoxSize=1.0,
    )
    model = Zeldovich(param)
    G = np.asarray(model.kspace())
    A = G[0]
    refl = np.conj(
        A[(-np.arange(ppd)) % ppd][:, (-np.arange(ppd)) % ppd][
            :, :, (-np.arange(ppd)) % ppd
        ]
    )
    D = 0.5 * (A + refl)
    nmodes = np.count_nonzero(np.abs(D) > 0)
    # variance of Re+Im of D is P/V = 1 (V=1); sample mean of |D|^2 ~ 1
    mean_power = (np.abs(D) ** 2).sum() / nmodes
    assert mean_power == pytest.approx(1.0, rel=0.05)

    x = np.asarray(model.xspace())
    dens = x[0].real
    # Parseval: var(delta_pixels) = sum |D_k|^2 (unnormalized inverse FFT
    # of variance-P/V modes): predicted rms = sqrt(nmodes * 1) approx
    rms = np.sqrt((dens**2).mean())
    assert rms == pytest.approx(np.sqrt(nmodes), rel=0.05)


def test_full_run_and_output_files(tmp_path):
    param = make_params(tmp_path, ppd=8, ZD_qdensity=1)
    model = Zeldovich(param)
    writer = model.run()
    out = param.output_path
    ics = sorted(out.glob("ic_*"))
    assert len(ics) == 8  # CPD == ppd: one file per slab
    rec = read_particles(ics[0], "RVZel")
    assert rec.shape == (64,)
    assert rec.dtype.itemsize == 32
    # lattice coords of slab z=0
    assert set(rec["i"]) == {0}
    assert list(rec["j"][:8]) == [0] * 8  # y-major
    assert list(rec["k"][:8]) == list(range(8))
    # velocities = vnorm * displ for non-PLT (f_cluster=1 -> vnorm=1)
    np.testing.assert_allclose(rec["vel"], rec["displ"], rtol=1e-6)

    dens = np.fromfile(out / "density8", dtype=np.float32)
    assert dens.size == 8**3
    # density file and stats agree
    assert writer.density_variance == pytest.approx(
        float((dens.astype(np.float64) ** 2).sum()), rel=1e-5
    )

    # records match the x-space decode
    x = np.asarray(model.xspace())
    np.testing.assert_allclose(
        rec["displ"][:, 2], x[0, :, 0, :].imag.astype(np.float32).ravel()
    )
    np.testing.assert_allclose(
        rec["displ"][:, 1], x[1, :, 0, :].real.astype(np.float32).ravel()
    )


def test_output_formats(tmp_path):
    for fmt, size in [
        ("RVdoubleZel", 56),
        ("Zeldovich", 32),
        ("ZelSimple", 12),
    ]:
        param = make_params(tmp_path, ppd=8, ICFormat=fmt)
        setup_output_dir(param)
        model = Zeldovich(param)
        model.run(setup_dir=True)
        rec = read_particles(param.output_path / "ic_0", fmt)
        assert rec.dtype.itemsize == size
        assert rec.shape == (64,)


def test_f_NL_changes_field_and_is_deterministic(tmp_path):
    p0 = make_params(tmp_path, ppd=8)
    p1 = make_params(tmp_path, ppd=8, ZD_f_NL=50.0, ZD_n_s=0.96, Omega_M=0.3)
    x0 = np.asarray(Zeldovich(p0).xspace())
    x1 = np.asarray(Zeldovich(p1).xspace())
    x1b = np.asarray(Zeldovich(p1).xspace())
    assert not np.allclose(x0, x1)
    np.testing.assert_array_equal(x1, x1b)
    assert np.all(np.isfinite(x1))


def test_f_NL_matches_emulator(tmp_path):
    """Full f_NL flow vs emulator using the same phi_k round trip."""
    param = make_params(tmp_path, ppd=8, ZD_f_NL=20.0, ZD_n_s=0.96, Omega_M=0.3)
    model = Zeldovich(param)
    phi_k = np.asarray(model.phi_kspace())
    Pk = PowerSpectrum(param)
    # emulator phi pass + config-space f_NL (numpy)
    phi_k_em = emulate_kgrid(param, Pk, gen_phi=True)[0]
    n = param.ppd
    phi_x = (np.fft.ifftn(phi_k_em) * n**3).real
    phi_x = (phi_x + param.f_NL * phi_x**2) / n**3
    phi_k_em = np.fft.fftn(phi_x)
    np.testing.assert_allclose(phi_k, phi_k_em, atol=1e-12 * np.abs(phi_k_em).max())

    want = inverse_fft3(emulate_kgrid(param, Pk, phi_k=phi_k_em))
    got = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize(
    "flags",
    [
        [],
        pytest.param(["--sharded", "--pair"], marks=pytest.mark.slow),
        ["--out-of-core"],
    ],
)
def test_part1_part2_checkpoint(tmp_path, flags):
    from zeldovich.cli import main

    par = tmp_path / "run.par"
    param_dict = dict(
        BoxSize=100.0,
        NP=8**3,
        CPD=8,
        ICFormat="RVZel",
        InitialConditionsDirectory=str(tmp_path / "ic"),
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
    lines = [
        f'{k} = "{v}"' if isinstance(v, str) else f"{k} = {v}"
        for k, v in param_dict.items()
    ]
    par.write_text("\n".join(lines) + "\n")

    assert main([str(par), "--part", "1", *flags]) == 0
    assert list((tmp_path / "ic").glob("zeldovich.kspace*"))  # chunked ckpt
    assert main([str(par), "--part", "2", *flags]) == 0
    assert not list((tmp_path / "ic").glob("zeldovich.kspace*"))

    # equals a single-shot run (same flags -> same code path, bit-equal)
    two_phase = read_particles(tmp_path / "ic" / "ic_0", "RVZel")
    assert main([str(par), *flags]) == 0
    one_shot = read_particles(tmp_path / "ic" / "ic_0", "RVZel")
    np.testing.assert_array_equal(two_phase, one_shot)


def test_oneslab_option(tmp_path):
    param = make_params(tmp_path, ppd=8, ZD_qoneslab=3)
    Zeldovich(param).run()
    ics = sorted(param.output_path.glob("ic_*"))
    assert [p.name for p in ics] == ["ic_3"]


def test_oversampling_file_level(tmp_path):
    """Phase-matched oversampling end-to-end: a 16^3 run with k_cutoff=2
    contains exactly the 8^3 run's modes, so its displacement field at the
    shared (even-index) lattice points equals the 8^3 field."""
    base = dict(ICFormat="RVdoubleZel")
    p8 = make_params(tmp_path / "a", ppd=8, CPD=8, **base)
    Zeldovich(p8).run()
    p16 = make_params(tmp_path / "b", ppd=16, CPD=16, ZD_k_cutoff=2.0, **base)
    Zeldovich(p16).run()

    def field(param):
        ppd = param.ppd
        out = np.zeros((ppd, ppd, ppd, 3))
        for fn in sorted(param.output_path.glob("ic_*")):
            rec = read_particles(fn, "RVdoubleZel")
            out[rec["i"], rec["j"], rec["k"]] = rec["displ"]
        return out

    f8 = field(p8)
    f16 = field(p16)
    np.testing.assert_allclose(
        f16[::2, ::2, ::2], f8, atol=1e-12 * np.abs(f8).max()
    )
