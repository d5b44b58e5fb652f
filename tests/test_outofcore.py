"""Out-of-core (host-staged) pipeline vs the in-core path."""

from pathlib import Path

import numpy as np
import pytest

from zeldovich.models.outofcore import OutOfCoreZeldovich
from zeldovich.models.pipeline import Zeldovich
from zeldovich.utils.output import read_particles
from zeldovich.utils.params import Parameters

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"

# full streamed-pipeline runs; CI's fast tier deselects with -m "not slow"
pytestmark = pytest.mark.slow


def make_params(tmp_path, ppd=16, **over):
    d = dict(
        BoxSize=100.0,
        NP=ppd**3,
        CPD=ppd,
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


def run_both(tmp_path, **over):
    p1 = make_params(tmp_path / "a", **over)
    Zeldovich(p1).run()
    p2 = make_params(tmp_path / "b", **over)
    # tiny slab size to force many passes
    OutOfCoreZeldovich(p2, slab_bytes=16 * 16 * 2 * 16 * 4).run()
    return p1, p2


def compare_outputs(p1, p2):
    a_files = sorted(p1.output_path.glob("ic_*"))
    b_files = sorted(p2.output_path.glob("ic_*"))
    assert [f.name for f in a_files] == [f.name for f in b_files]
    for fa, fb in zip(a_files, b_files):
        ra = read_particles(fa, p1.ICFormat)
        rb = read_particles(fb, p2.ICFormat)
        np.testing.assert_array_equal(ra["i"], rb["i"])
        np.testing.assert_allclose(ra["displ"], rb["displ"], atol=1e-12)
        np.testing.assert_allclose(ra["vel"], rb["vel"], atol=1e-12)


def test_matches_incore(tmp_path):
    compare_outputs(*run_both(tmp_path))


def test_matches_incore_f_NL(tmp_path):
    compare_outputs(*run_both(tmp_path, ZD_f_NL=25.0, ZD_n_s=0.96, Omega_M=0.3))


def test_disk_backing(tmp_path):
    p1 = make_params(tmp_path / "a")
    Zeldovich(p1).run()
    p2 = make_params(tmp_path / "b")
    m = OutOfCoreZeldovich(p2, slab_bytes=1 << 16, backing="disk")
    from zeldovich.utils.output import setup_output_dir

    setup_output_dir(p2)  # memmap file lives under the output dir
    stage = m.stage_pass1()
    assert (p2.output_path / "zeldovich.stage.mm").exists()
    del stage
    m.run(setup_dir=False)  # allocates + consumes its own stage
    # quickdelete: a completed run reclaims the staged fabric
    assert not (p2.output_path / "zeldovich.stage.mm").exists()
    compare_outputs(p1, p2)


def test_disk_backing_f_NL_drops_phi_stage(tmp_path):
    """The phi fabric file is removed once pass 1 has consumed it."""
    fnl = dict(ZD_f_NL=25.0, ZD_n_s=0.96, Omega_M=0.3)
    p1 = make_params(tmp_path / "a", **fnl)
    Zeldovich(p1).run()
    p2 = make_params(tmp_path / "b", **fnl)
    m = OutOfCoreZeldovich(p2, slab_bytes=1 << 16, backing="disk")
    from zeldovich.utils.output import setup_output_dir

    setup_output_dir(p2)
    m.run(setup_dir=False)
    assert not (p2.output_path / "zeldovich.phi.mm").exists()
    compare_outputs(p1, p2)


def test_checkpoint_roundtrip(tmp_path):
    """stage_pass1 output is the PART1/PART2 boundary."""
    param = make_params(tmp_path)
    m = OutOfCoreZeldovich(param, slab_bytes=1 << 20)
    from zeldovich.utils.output import setup_output_dir

    setup_output_dir(param)
    stage = m.stage_pass1()
    # a second model resumes from the staged state
    param2 = make_params(tmp_path)
    m2 = OutOfCoreZeldovich(param2, slab_bytes=1 << 20)
    m2.run(setup_dir=False, stage=stage)
    ref = make_params(tmp_path / "ref")
    Zeldovich(ref).run()
    compare_outputs(ref, param2)


def test_sharded_outofcore_matches(tmp_path):
    """Mesh + host staging combined (the -DDISK NumBlock>2 analog)."""
    import jax
    import pytest

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    from zeldovich.parallel.mesh import make_mesh

    p1 = make_params(tmp_path / "a")
    Zeldovich(p1).run()
    for pair in (False, True):
        sub = tmp_path / f"pair{pair}"
        p2 = make_params(sub)
        mesh = make_mesh(mesh_shape=(4, 2))
        m = OutOfCoreZeldovich(p2, slab_bytes=1 << 16, pair=pair, mesh=mesh)
        assert m.slab < p2.ppd  # several slabs
        assert m.slab % 2 == 0 and m.slab % 4 == 0
        m.run()
        compare_outputs(p1, p2)


def test_sharded_outofcore_plt(tmp_path):
    import jax
    import pytest

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    from zeldovich.parallel.mesh import make_mesh

    plt_kw = dict(
        ZD_qPLT=1,
        ZD_PLT_filename=str(ASSETS / "eigmodes128"),
        ZD_qPLT_rescale=1,
        ZD_PLT_target_z=5.0,
    )
    p1 = make_params(tmp_path / "a", **plt_kw)
    Zeldovich(p1).run()
    p2 = make_params(tmp_path / "b", **plt_kw)
    mesh = make_mesh(devices=jax.devices()[:4], mesh_shape=(2, 2))
    m = OutOfCoreZeldovich(p2, slab_bytes=1 << 18, pair=False, mesh=mesh)
    m.run()
    compare_outputs(p1, p2)


def test_sharded_outofcore_f_NL(tmp_path):
    """f_NL phi round trip through the mesh + host staging fabric."""
    import jax
    import pytest

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    from zeldovich.parallel.mesh import make_mesh

    fnl_kw = dict(ZD_f_NL=25.0, ZD_n_s=0.96, Omega_M=0.3)
    p1 = make_params(tmp_path / "a", **fnl_kw)
    Zeldovich(p1).run()
    for pair in (False, True):
        sub = tmp_path / f"pair{pair}"
        p2 = make_params(sub, **fnl_kw)
        mesh = make_mesh(mesh_shape=(4, 2))
        m = OutOfCoreZeldovich(p2, slab_bytes=1 << 16, pair=pair, mesh=mesh)
        assert m.slab < p2.ppd  # several slabs
        m.run()
        compare_outputs(p1, p2)


def test_df64_outofcore_parity(tmp_path):
    """Streamed df64 (mixed parity) run < 1e-6 displacement error vs f64.

    The in-core df64 mode tops out where the pair intermediates exceed
    HBM; this is the same numerics streamed through host staging slabs.
    """
    import jax.numpy as jnp

    ppd = 16
    p1 = make_params(tmp_path / "a", ppd=ppd)
    Zeldovich(p1, dtype=jnp.float64).run()
    p2 = make_params(tmp_path / "b", ppd=ppd)
    m = OutOfCoreZeldovich(p2, dtype="df64", slab_bytes=1 << 15)
    assert m.mixed and m.pair and m.slab < ppd
    m.run()
    for fa in sorted(p1.output_path.glob("ic_*")):
        ra = read_particles(fa, p1.ICFormat)
        rb = read_particles(p2.output_path / fa.name, p2.ICFormat)
        np.testing.assert_array_equal(ra["i"], rb["i"])
        err = np.abs(ra["displ"] - rb["displ"]).max()
        assert err < 1e-6, f"df64 ooc displacement error {err:.3e}"
        np.testing.assert_allclose(ra["vel"], rb["vel"], atol=1e-6)


def test_df64_outofcore_f_NL_fallback(tmp_path):
    """df64 + f_NL streams through the full-f64 pair kernels (same parity).

    The input-phi pass is not Hermitian-exact, so the mixed mode's exact-
    primitive f32 draw chain does not apply; the constructor downgrades to
    mixed=False (full-f64 pair) instead of refusing -- mirroring the
    in-core fallback (models/pipeline.xspace_half_df64_sharded).
    Reference runs f_NL in DISK mode at any NumBlock
    (/root/reference/src/zeldovich.cpp:946-959).
    """
    fnl = dict(ZD_f_NL=25.0, ZD_n_s=0.96, Omega_M=0.3)
    p1 = make_params(tmp_path / "a", **fnl)
    OutOfCoreZeldovich(p1, slab_bytes=1 << 15, pair=True).run()
    p2 = make_params(tmp_path / "b", **fnl)
    m = OutOfCoreZeldovich(p2, dtype="df64", slab_bytes=1 << 15)
    assert not m.mixed and m.pair  # downgraded, not refused
    m.run()
    compare_outputs(p1, p2)


def test_one_compile_per_shape(tmp_path):
    """y0 is a traced scalar: streaming N slabs compiles the kernel once.

    (At 4096^3 with 64 slabs, a static y0 would mean 64 identical XLA
    compilations per pass.)
    """
    from zeldovich.models.outofcore import _synth_ifft_zx, _synth_ifft_zx_pair

    param = make_params(tmp_path)
    m = OutOfCoreZeldovich(param, slab_bytes=16 * 16 * 2 * 16 * 4, pair=False)
    assert m.slab < param.ppd  # several slabs
    _synth_ifft_zx._clear_cache()
    for y0 in range(0, param.ppd, m.slab):
        _synth_ifft_zx(y0, m.slab, m.cfg, m.tables, m.dtype)
    assert _synth_ifft_zx._cache_size() == 1

    _synth_ifft_zx_pair._clear_cache()
    for y0 in range(0, param.ppd, m.slab):
        _synth_ifft_zx_pair(y0, m.slab, m.cfg, m.tables, m.dtype)
    assert _synth_ifft_zx_pair._cache_size() == 1


def test_pair_mode_matches(tmp_path):
    """Complex-free out-of-core run equals the complex one (incl f_NL)."""
    for extra in ({}, {"ZD_f_NL": 20.0, "ZD_n_s": 0.96, "Omega_M": 0.3}):
        p1 = make_params(tmp_path / "a", **extra)
        OutOfCoreZeldovich(p1, slab_bytes=1 << 15, pair=False).run()
        p2 = make_params(tmp_path / "b", **extra)
        # small slab: several passes (regression for the pair stage layout)
        m = OutOfCoreZeldovich(p2, slab_bytes=1 << 15, pair=True)
        assert m.slab < p2.ppd
        m.run()
        compare_outputs(p1, p2)


def test_matches_incore_v1(tmp_path):
    """Legacy ZD_Version=1 through the streamed pipeline == in-core v1.

    The reference runs v1 in DISK mode at any NumBlock
    (zeldovich.cpp:946-979 with the v1 RNG, power_spectrum.cpp:18-25);
    this is the scale-mode analog: the host-generated MT19937 D field
    feeds the per-slab synthesis (D_source slicing) and the staged
    transforms.  Complex path (v1 is host-generated by construction).
    """
    compare_outputs(
        *run_both(tmp_path, ZD_Version=1, ZD_NumBlock=4)
    )


def test_matches_incore_v1_disk(tmp_path):
    """v1 + disk backing: the closest analog of the reference's
    v1 -DDISK configuration."""
    p1 = make_params(tmp_path / "a", ZD_Version=1, ZD_NumBlock=4)
    Zeldovich(p1).run()
    p2 = make_params(tmp_path / "b", ZD_Version=1, ZD_NumBlock=4)
    OutOfCoreZeldovich(p2, slab_bytes=1 << 16, backing="disk").run()
    compare_outputs(p1, p2)
