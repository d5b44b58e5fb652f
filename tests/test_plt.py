"""PLT eigenmode lookup + end-to-end PLT pipeline vs the emulator."""

import math
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from reference_emulator import emulate_kgrid
from zeldovich.ops import plt as plt_ops
from zeldovich.ops.modes import SynthConfig, SynthTables, synthesize_slab
from zeldovich.utils.params import Parameters
from zeldovich.utils.power import PowerSpectrum, mode_amplitude_tables

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def synthetic_table(ppd_e: int, seed=0) -> np.ndarray:
    """A physically-shaped random eigenmode table: unit vectors near k-hat
    plus noise, eigenvalues near 1 with scatter."""
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(ppd_e, d=1 / ppd_e)  # 0..N/2-1, -N/2..-1 order? no:
    # table index i corresponds to numpy fft convention used by the loader:
    # index = wavenumber mod ppd_e for x,y; z only 0..ppd_e/2
    shape = (ppd_e, ppd_e, ppd_e // 2 + 1)
    ix = np.arange(ppd_e)
    kxi = np.where(ix > ppd_e // 2, ix - ppd_e, ix)
    # numpy convention: freq[N/2] = -N/2 (per the reference comment)
    kxi = np.where(ix == ppd_e // 2, -ppd_e // 2, kxi)
    KX = kxi[:, None, None] * np.ones(shape)
    KY = kxi[None, :, None] * np.ones(shape)
    KZ = np.arange(ppd_e // 2 + 1)[None, None, :] * np.ones(shape)
    kmag = np.sqrt(KX**2 + KY**2 + KZ**2)
    kmag[0, 0, 0] = 1.0
    vec = np.stack([KX, KY, KZ], axis=-1) / kmag[..., None]
    vec += 0.05 * rng.normal(size=vec.shape)
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    val = 1.0 + 0.2 * rng.normal(size=shape)
    table = np.concatenate([vec, val[..., None]], axis=-1)
    table[0, 0, 0] = [0, 0, 1, 1]  # arbitrary finite entry at k=0
    return table


def scalar_eig_lookup(table, ppd):
    """Literal scalar transcription of get_eigenmode/interp_eigmode for the
    emulator (independent of the vectorized device implementation)."""
    eig_ppd = table.shape[0]
    halfppd = eig_ppd // 2 + 1
    ppdhalf = eig_ppd // 2
    flat = table.reshape(-1)

    def EIG(ikx, iky, ikz, i):
        return flat[((ikx * eig_ppd + iky) * halfppd + ikz) * 4 + i]

    def interp(ikx, iky, ikz):
        if eig_ppd % ppd == 0:
            s = eig_ppd // ppd
            return [EIG(ikx * s, iky * s, ikz * s, i) for i in range(4)]
        fx = eig_ppd / ppd * ikx
        fy = eig_ppd / ppd * iky
        fz = eig_ppd / ppd * ikz
        if ppdhalf < fx < halfppd:
            fx = math.floor(fx + 1)
        if ppdhalf < fy < halfppd:
            fy = math.floor(fy + 1)
        if ppdhalf < fz < halfppd:
            fz = math.floor(fz + 1)
        ixl, iyl, izl = int(fx), int(fy), int(fz)
        ixh, iyh, izh = ixl + 1, iyl + 1, izl + 1
        if ixh == eig_ppd:
            ixh = 0
        if iyh == eig_ppd:
            iyh = 0
        if izh == eig_ppd:
            izh = 0
        fx -= ixl
        fy -= iyl
        fz -= izl
        izh = min(izh, halfppd - 1)  # weight is 0 there when clamped
        w = [
            (1 - fx) * (1 - fy) * (1 - fz),
            (1 - fx) * (1 - fy) * fz,
            (1 - fx) * fy * (1 - fz),
            (1 - fx) * fy * fz,
            fx * (1 - fy) * (1 - fz),
            fx * (1 - fy) * fz,
            fx * fy * (1 - fz),
            fx * fy * fz,
        ]
        pts = [
            (ixl, iyl, izl),
            (ixl, iyl, izh),
            (ixl, iyh, izl),
            (ixl, iyh, izh),
            (ixh, iyl, izl),
            (ixh, iyl, izh),
            (ixh, iyh, izl),
            (ixh, iyh, izh),
        ]
        return [
            sum(w[j] * EIG(*pts[j], i) for j in range(8)) for i in range(4)
        ]

    def lookup(kx, ky, kz):
        ikx = kx + ppd if kx < 0 else kx
        iky = ky + ppd if ky < 0 else ky
        ikz = kz + ppd if kz < 0 else kz
        if ikz > ppd // 2:
            ikz = ppd - ikz
        e = interp(ikx, iky, ikz)
        ex, ey, ez, ev = e
        ez *= math.copysign(1, kz)
        mag = math.sqrt(ex * ex + ey * ey + ez * ez)
        ex, ey, ez = ex / mag, ey / mag, ez / mag
        k2 = kx * kx + ky * ky + kz * kz
        dot = kx * ex + ky * ey + kz * ez
        norm = k2 / dot if dot != 0 else float("inf")
        if k2 == 0 or not math.isfinite(norm):
            norm = 0.0
        return (norm * ex, norm * ey, norm * ez), ev

    return lookup


@pytest.mark.parametrize("ppd,ppd_e", [(8, 8), (8, 16), (16, 8), (12, 8)])
def test_lookup_matches_scalar(ppd, ppd_e):
    table = synthetic_table(ppd_e)
    lookup = scalar_eig_lookup(table, ppd)
    half = ppd // 2
    ks = np.arange(-half + 1, half + 1)
    KX, KY, KZ = np.meshgrid(ks, ks, ks, indexing="ij")
    (ex, ey, ez), ev = plt_ops.eigenmode_lookup(
        jnp.asarray(KX), jnp.asarray(KY), jnp.asarray(KZ), ppd, jnp.asarray(table)
    )
    ex, ey, ez, ev = map(np.asarray, (ex, ey, ez, ev))
    for idx in np.ndindex(KX.shape):
        kx, ky, kz = int(KX[idx]), int(KY[idx]), int(KZ[idx])
        (wx, wy, wz), wv = lookup(kx, ky, kz)
        np.testing.assert_allclose(
            [ex[idx], ey[idx], ez[idx], ev[idx]],
            [wx, wy, wz, wv],
            atol=1e-12,
            err_msg=f"k={(kx, ky, kz)}",
        )


def test_table_io_roundtrip(tmp_path):
    table = synthetic_table(8)
    path = tmp_path / "eig8"
    plt_ops.save_eigmodes(path, table)
    back = plt_ops.load_eigmodes(path)
    np.testing.assert_array_equal(back, table)
    # header is a 4-byte int
    import struct

    assert struct.unpack("<i", path.read_bytes()[:4])[0] == 8


@pytest.mark.parametrize("rescale", [0, 1])
def test_plt_pipeline_matches_emulator(tmp_path, rescale):
    ppd = 8
    table = synthetic_table(16, seed=2)
    eig_path = tmp_path / "eig16"
    plt_ops.save_eigmodes(eig_path, table)

    param = Parameters.from_dict(
        dict(
            BoxSize=100.0,
            NP=ppd**3,
            CPD=100,
            ICFormat="RVZel",
            InitialConditionsDirectory="/tmp/ic",
            InitialRedshift=49.0,
            ZD_Seed=12346,
            ZD_NumBlock=2,
            ZD_Pk_scale=1.0,
            ZD_Pk_norm=8.0,
            ZD_Pk_sigma=0.02,
            ZD_Pk_smooth=0.0,
            ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
            ZD_Version=2,
            ZD_qPLT=1,
            ZD_PLT_filename=str(eig_path),
            ZD_qPLT_rescale=rescale,
            ZD_PLT_target_z=5.0,
            ZD_f_cluster=0.9,
        )
    )
    Pk = PowerSpectrum(param)
    pk_n2, M_n2 = mode_amplitude_tables(Pk, param)
    cfg = SynthConfig.from_params(param, Pk.fixed_power)
    tables = SynthTables.build(
        param.seed, ppd, pk_n2, M_n2, eig=plt_ops.load_eigmodes(eig_path)
    )
    assert cfg.narray == 4
    got = np.asarray(synthesize_slab(0, ppd, cfg, tables))
    want = emulate_kgrid(param, Pk, eig_lookup=scalar_eig_lookup(table, ppd))
    np.testing.assert_allclose(got, want, atol=1e-13 * np.abs(want).max())
