"""The --dtype df64 parity mode on the (virtual 8-way CPU) device mesh.

The parity-grade numerics must run on a sharded mesh too (in-core and
out-of-core).
Parity bar: <1e-6 displacement error vs the f64 complex reference
(BASELINE.md), the same target the single-device df64 mode meets.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zeldovich.models.pipeline import Zeldovich
from zeldovich.parallel.mesh import make_mesh
from zeldovich.utils.params import Parameters

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def make_params(ppd=16, **over):
    d = dict(
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
    )
    d.update(over)
    return Parameters.from_dict(d)


def _f64_reference(param):
    """x-space pair image of the full-f64 complex pipeline."""
    x = np.asarray(Zeldovich(param, dtype=jnp.float64).xspace())
    return np.stack([x.real, x.imag], axis=1)


def _parity(got, want):
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale


@pytest.mark.slow
@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)])
def test_df64_sharded_parity_shapes(mesh_shape):
    """Extra mesh shapes (the (4, 2) shape runs in the fast tier)."""
    test_df64_sharded_parity(mesh_shape)


@pytest.mark.slow  # 52 s: the heaviest df64 mesh check (CI tier budget)
@pytest.mark.parametrize("mesh_shape", [(4, 2)])
def test_df64_sharded_parity(mesh_shape):
    param = make_params(ppd=16)
    mesh = make_mesh(mesh_shape=mesh_shape)
    model = Zeldovich(param, dtype=jnp.float32)
    got = np.asarray(model.xspace_half_df64_sharded(mesh))
    assert got.dtype == np.float64
    assert _parity(got, _f64_reference(param)) < 1e-6


@pytest.mark.slow  # 34 s (CI fast-tier budget)
def test_df64_sharded_matches_incore_tight():
    """Sharded and in-core df64 agree to a few f32 ulp.

    Not bitwise: XLA contracts a*b+c chains into FMAs per compiled
    program, so two differently-jitted graphs of the same math round
    differently at the last f32 bit (measured: jit vs eager of the SAME
    synthesis function differs by ~1 ulp on CPU).  The contract is the
    parity bar, plus this tight cross-path consistency bound.
    """
    param = make_params(ppd=16)
    mesh = make_mesh(mesh_shape=(4, 2))
    model = Zeldovich(param, dtype=jnp.float32)
    got = np.asarray(model.xspace_half_df64_sharded(mesh))
    want = np.asarray(model.xspace_half_df64())
    assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()


@pytest.mark.slow
def test_df64_sharded_zplanes_layout():
    param = make_params(ppd=16)
    mesh = make_mesh(mesh_shape=(4, 2))
    model = Zeldovich(param, dtype=jnp.float32)
    x = model.xspace_half_df64_sharded(mesh, zplanes=True)
    # every device owns whole z-planes
    for s in x.addressable_shards:
        assert s.data.shape[-1] == param.ppd and s.data.shape[-3] == param.ppd
    want = np.asarray(model.xspace_half_df64_sharded(mesh))
    np.testing.assert_array_equal(np.asarray(x), want)


@pytest.mark.slow
def test_df64_sharded_plt():
    param = make_params(
        ppd=16,
        ZD_qPLT=1,
        ZD_qPLT_rescale=0,
        ZD_PLT_target_z=5.0,
        ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    )
    mesh = make_mesh(mesh_shape=(2, 4))
    model = Zeldovich(param, dtype=jnp.float32)
    got = np.asarray(model.xspace_half_df64_sharded(mesh))
    assert got.shape[0] == 4
    assert _parity(got, _f64_reference(param)) < 1e-6


def test_df64_four_step_transform():
    """n > DENSE_MAX exercises the pair four-step (twiddle pair_mul) path."""
    from zeldovich.ops import mmfft

    rng = np.random.default_rng(3)
    n = 36  # non-prime: 6 x 6 four-step split
    a = rng.normal(size=(5, n)).astype(np.float32).astype(np.float64)
    old = mmfft.DENSE_MAX
    try:
        re, im = (jnp.asarray(a, jnp.float32), jnp.zeros((5, n), jnp.float32))
        zero = jnp.zeros_like(re)
        mmfft.DENSE_MAX = n  # dense reference
        dr, di = mmfft._cfft_last_df64((re, zero), (im, zero), +1)
        dense = np.stack([np.asarray(dr[0], np.float64) + np.asarray(dr[1]),
                          np.asarray(di[0], np.float64) + np.asarray(di[1])])
        mmfft.DENSE_MAX = 8  # force four-step
        fr, fi = mmfft._cfft_last_df64((re, zero), (im, zero), +1)
        four = np.stack([np.asarray(fr[0], np.float64) + np.asarray(fr[1]),
                         np.asarray(fi[0], np.float64) + np.asarray(fi[1])])
    finally:
        mmfft.DENSE_MAX = old
    want = np.fft.ifft(a, axis=-1) * n  # FFTW +1 unnormalized
    wpair = np.stack([want.real, want.imag])
    assert np.abs(dense - wpair).max() < 1e-9 * np.abs(wpair).max()
    assert np.abs(four - wpair).max() < 1e-9 * np.abs(wpair).max()


@pytest.mark.slow  # ~8 s; the sharded df64 end-to-end tests keep the c2r
# df64 path covered in the fast tier
def test_c2r_y_df64_assembled_matches_dense():
    """The assembled (four-step-capable) c2r form == the dense c2r form."""
    from zeldovich.ops import mmfft

    param = make_params(ppd=16)
    model = Zeldovich(param, dtype=jnp.float32)
    from zeldovich.ops.modes_real import synthesize_half_pair

    spm = synthesize_half_pair(
        model.cfg, model.tables, dtype=jnp.float32,
        pk_eff=model.pk_eff, accurate=True,
    )
    z = jnp.zeros_like(spm[..., 0, :, :, :])
    rep = (spm[..., 0, :, :, :], z)
    imp = (spm[..., 1, :, :, :], z)
    for ax in (-2, -1):
        rep, imp = mmfft._cfft_axis_df64(rep, imp, ax, +1)
    dense_re, dense_im = mmfft._c2r_y_df64(rep, imp)
    old = mmfft.DENSE_MAX
    try:
        mmfft.DENSE_MAX = 8
        asm_re, asm_im = mmfft._c2r_y_df64(rep, imp)
    finally:
        mmfft.DENSE_MAX = old

    def to64(p):
        return np.asarray(p[0], np.float64) + np.asarray(p[1], np.float64)

    scale = np.abs(to64(dense_re)).max()
    assert np.abs(to64(asm_re) - to64(dense_re)).max() < 1e-9 * scale
    assert np.abs(to64(asm_im) - to64(dense_im)).max() < 1e-9 * scale


@pytest.mark.slow
def test_ozaki_f64_under_shard_map(monkeypatch):
    """Force the accelerator f64 route (Ozaki int8 matmuls) under
    shard_map on CPU: the pod parity fallback must execute and stay
    within f64-transform-grade error of the real-BLAS result."""
    from zeldovich.ops import ozaki

    param = make_params(ppd=16)
    mesh = make_mesh(mesh_shape=(4, 2))
    model = Zeldovich(param, dtype=jnp.float64)
    want = np.asarray(model.xspace_pair_sharded(mesh))  # real f64 BLAS
    monkeypatch.setenv("ZT_OZAKI", "1")
    assert ozaki.use_ozaki(jnp.float64)
    got = np.asarray(
        Zeldovich(param, dtype=jnp.float64).xspace_pair_sharded(mesh)
    )
    scale = np.abs(want).max()
    assert 0 < np.abs(got - want).max() < 1e-9 * scale


@pytest.mark.slow
def test_df64_ooc_sharded_matches_single_device(tmp_path):
    """--dtype df64 --out-of-core --sharded == the single-device df64 OOC
    to a few f32 ulp (different compiled programs; FMA contraction --
    see test_df64_sharded_matches_incore_tight)."""
    from zeldovich.models.outofcore import OutOfCoreZeldovich
    from zeldovich.utils.output import read_particles

    ppd = 16
    outs = {}
    for name, mesh in (("single", None), ("mesh", make_mesh(mesh_shape=(4, 2)))):
        param = make_params(
            ppd=ppd, InitialConditionsDirectory=str(tmp_path / name)
        )
        m = OutOfCoreZeldovich(
            param, dtype="df64", slab_bytes=ppd**2 * 16 * 2 * 4, mesh=mesh
        )
        m.run()
        outs[name] = sorted((tmp_path / name).glob("ic_*"))
    assert [p.name for p in outs["single"]] == [p.name for p in outs["mesh"]]
    for a, b in zip(outs["single"], outs["mesh"]):
        ra, rb = read_particles(a, "RVZel"), read_particles(b, "RVZel")
        np.testing.assert_array_equal(ra["i"], rb["i"])
        for fld in ("displ", "vel"):
            scale = np.abs(ra[fld]).max()
            assert np.abs(ra[fld] - rb[fld]).max() < 1e-6 * scale, a.name


@pytest.mark.slow
def test_df64_ooc_sharded_parity(tmp_path):
    """Displacements from the sharded df64 OOC run meet the parity bar."""
    from zeldovich.models.outofcore import OutOfCoreZeldovich
    from zeldovich.utils.output import read_particles

    ppd = 16
    param = make_params(
        ppd=ppd, InitialConditionsDirectory=str(tmp_path / "mesh"),
        ICFormat="RVdoubleZel",
    )
    m = OutOfCoreZeldovich(
        param, dtype="df64", slab_bytes=ppd**2 * 16 * 2 * 4,
        mesh=make_mesh(mesh_shape=(2, 4)),
    )
    m.run()
    want = _f64_reference(param)
    # displ (z,y,x) order = (Im B, Re B, Im A); A=arr0, B=arr1 pairs
    got = np.concatenate(
        [
            read_particles(f, "RVdoubleZel")["displ"]
            for f in sorted(
                (tmp_path / "mesh").glob("ic_*"),
                key=lambda p: int(p.name.split("_")[1]),
            )
        ]
    ).reshape(ppd, ppd, ppd, 3)
    ref = np.stack(
        [want[1, 1], want[1, 0], want[0, 1]], axis=-1
    )  # (Y,Z,X,3) -> reorder to slab-major (z, y, x)
    ref = np.moveaxis(ref, (0, 1), (1, 0))  # (Z, Y, X, 3)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-6 * scale
