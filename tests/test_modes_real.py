"""Real-pair (complex-free) synthesis vs the complex fast path."""

import numpy as np
import pytest

import jax.numpy as jnp

from test_modes import make_setup
from zeldovich.ops.modes_fast import synthesize_full_fast
from zeldovich.ops.modes_real import synthesize_full_fast_pair


def as_complex(pairs):
    return np.asarray(pairs[:, 0]) + 1j * np.asarray(pairs[:, 1])


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"ZD_qPk_fix_to_mean": 1},
        {"ZD_k_cutoff": 2.0},
        {"ZD_qdensity": 2},
    ],
)
def test_pair_equals_complex(kw):
    param, Pk, cfg, tables = make_setup(ppd=12, **kw)
    pair = as_complex(np.asarray(synthesize_full_fast_pair(cfg, tables, dtype=jnp.float64)))
    want = np.asarray(synthesize_full_fast(cfg, tables))
    scale = np.abs(want).max()
    np.testing.assert_allclose(pair, want, atol=2e-15 * scale, rtol=0)


def test_pair_gen_phi_and_input():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_f_NL=10.0)
    pair = as_complex(
        np.asarray(synthesize_full_fast_pair(cfg, tables, dtype=jnp.float64, gen_phi=True))
    )
    want = np.asarray(synthesize_full_fast(cfg, tables, gen_phi=True))
    np.testing.assert_allclose(pair, want, atol=2e-15 * np.abs(want).max(), rtol=0)

    rng = np.random.default_rng(5)
    phi = rng.normal(size=(8, 8, 8)) + 1j * rng.normal(size=(8, 8, 8))
    phi_pair = jnp.stack([jnp.asarray(phi.real), jnp.asarray(phi.imag)])
    pair = as_complex(
        np.asarray(
            synthesize_full_fast_pair(cfg, tables, dtype=jnp.float64, phi_pair=phi_pair)
        )
    )
    want = np.asarray(synthesize_full_fast(cfg, tables, phi_k=jnp.asarray(phi)))
    np.testing.assert_allclose(pair, want, atol=2e-15 * np.abs(want).max(), rtol=0)


@pytest.mark.slow  # ~4 s; PLT pair parity stays fast via test_fast_plt
# and the sharded PLT half-spectrum test
def test_pair_plt(tmp_path):
    from test_plt import synthetic_table
    from zeldovich.ops import plt as plt_ops
    from zeldovich.ops.modes import SynthConfig, SynthTables
    from zeldovich.utils.params import Parameters
    from zeldovich.utils.power import PowerSpectrum, mode_amplitude_tables
    from pathlib import Path

    table = synthetic_table(16, seed=4)
    eig_path = tmp_path / "eig"
    plt_ops.save_eigmodes(eig_path, table)
    ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"
    param = Parameters.from_dict(
        dict(
            BoxSize=100.0,
            NP=8**3,
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
            ZD_qPLT_rescale=1,
            ZD_PLT_target_z=5.0,
        )
    )
    Pk = PowerSpectrum(param)
    pk_n2, M_n2 = mode_amplitude_tables(Pk, param)
    cfg = SynthConfig.from_params(param, Pk.fixed_power)
    tables = SynthTables.build(
        param.seed, 8, pk_n2, M_n2, eig=plt_ops.load_eigmodes(eig_path)
    )
    pair = as_complex(np.asarray(synthesize_full_fast_pair(cfg, tables, dtype=jnp.float64)))
    want = np.asarray(synthesize_full_fast(cfg, tables))
    np.testing.assert_allclose(pair, want, atol=2e-15 * np.abs(want).max(), rtol=0)


def test_pair_pipeline_end_to_end(tmp_path):
    """run_pair produces the same particles as the complex run."""
    from zeldovich.models.pipeline import Zeldovich
    from zeldovich.utils.output import read_particles
    from zeldovich.utils.params import Parameters
    from pathlib import Path

    ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"

    def params(sub, **over):
        d = dict(
            BoxSize=100.0,
            NP=16**3,
            CPD=16,
            ICFormat="RVZel",
            InitialConditionsDirectory=str(tmp_path / sub),
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

    for extra in ({}, {"ZD_f_NL": 25.0, "ZD_n_s": 0.96, "Omega_M": 0.3}):
        pa = params("a", **extra)
        Zeldovich(pa).run()
        pb = params("b", **extra)
        Zeldovich(pb).run_pair()
        for fa, fb in zip(
            sorted(pa.output_path.glob("ic_*")), sorted(pb.output_path.glob("ic_*"))
        ):
            ra = read_particles(fa, "RVZel")
            rb = read_particles(fb, "RVZel")
            np.testing.assert_allclose(ra["displ"], rb["displ"], atol=1e-10)


@pytest.mark.parametrize("over", [
    {},
    {"ZD_qPLT": 1, "ZD_PLT_filename": None,  # set below
     "ZD_qPLT_rescale": 1, "ZD_PLT_target_z": 5.0},
    {"ZD_qdensity": 2},
    {"ZD_qPk_fix_to_mean": 1},
    {"ZD_k_cutoff": 2.0},
])
@pytest.mark.parametrize(
    "y0,ny",
    # the generated half [0, 8) of a 16^3 grid, slabs that straddle its
    # edge, and mirror-half slabs (y0 >= half)
    [(0, 4), (4, 4), (2, 3), (6, 4), (8, 4), (12, 4), (9, 3)],
)
def test_slab_identity_matches_hermitian_path(over, y0, ny):
    """The out-of-core slab synthesis == synthesize_pair.

    synthesize_slab_pair takes the gather-free identity path for slabs
    inside the generated half (y0 + ny <= half) and the hermitian_source
    path otherwise.  The identity path must reproduce the generic one
    bit-for-bit where it applies -- including the ky=0 conjugate-reflect
    fixup (y0 == 0 slabs), the origin's sign-of-zero, PLT f products,
    and the zero rules.
    """
    from zeldovich.ops.modes_real import (
        synthesize_pair,
        synthesize_slab_pair,
        synthesize_slab_pair_identity,
    )

    over = dict(over)
    if over.get("ZD_qPLT"):
        # PLT needs the eigenmode table: build through the model
        from helpers import ASSETS, plt_model

        over["ZD_PLT_filename"] = str(ASSETS / "eigmodes128")
        model = plt_model(ppd=16)
        cfg, tables = model.cfg, model.tables
    else:
        param, Pk, cfg, tables = make_setup(ppd=16, **over)
    ppd = cfg.ppd
    y = (y0 + jnp.arange(ny))[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]
    want = np.asarray(
        synthesize_pair(y, z, x, cfg, tables, dtype=jnp.float32)
    )
    if y0 + ny <= ppd // 2:
        ident = np.asarray(
            synthesize_slab_pair_identity(
                y0, ny, cfg, tables, dtype=jnp.float32
            )
        )
        assert want.shape == ident.shape
        np.testing.assert_array_equal(
            want.view(np.uint32), ident.view(np.uint32)
        )
    # the dispatcher runs compiled (both forms behind one cond), where
    # XLA may contract the float ops differently from the eager
    # reference: equal to within an f32 ulp of the field's scale
    got = np.asarray(
        synthesize_slab_pair(jnp.int32(y0), ny, cfg, tables, dtype=jnp.float32)
    )
    assert want.shape == got.shape
    np.testing.assert_allclose(
        got, want, atol=2e-7 * np.abs(want).max(), rtol=0
    )


@pytest.mark.parametrize(
    "extra", [{}, {"ZD_f_NL": 20.0, "ZD_n_s": 0.96, "Omega_M": 0.3}],
    ids=["plain", "f_NL"],
)
def test_outofcore_pair_mode_matches_complex(tmp_path, extra):
    """--out-of-core --pair == the complex out-of-core run at 16^3, with
    slabs in both halves of the grid (the mirror-half slab regression)."""
    from zeldovich.models.outofcore import OutOfCoreZeldovich
    from zeldovich.utils.output import read_particles
    from test_outofcore import make_params

    p1 = make_params(tmp_path / "a", **extra)
    OutOfCoreZeldovich(p1, slab_bytes=1 << 15, pair=False).run()
    p2 = make_params(tmp_path / "b", **extra)
    m = OutOfCoreZeldovich(p2, slab_bytes=1 << 15, pair=True)
    assert m.slab < p2.ppd // 2  # slabs on both sides of ky = half
    m.run()
    names = sorted(f.name for f in p1.output_path.glob("ic_*"))
    assert names == sorted(f.name for f in p2.output_path.glob("ic_*"))
    for name in names:
        ra = read_particles(p1.output_path / name, p1.ICFormat)
        rb = read_particles(p2.output_path / name, p2.ICFormat)
        np.testing.assert_array_equal(ra["i"], rb["i"])
        np.testing.assert_allclose(ra["displ"], rb["displ"], atol=1e-12)
        np.testing.assert_allclose(ra["vel"], rb["vel"], atol=1e-12)
