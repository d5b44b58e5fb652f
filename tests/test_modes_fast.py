"""Half-space fast path vs the reference-exact elementwise path."""

import numpy as np
import pytest

import jax.numpy as jnp

from test_modes import make_setup, full_grid
from zeldovich.ops.modes_fast import synthesize_full_fast


def assert_same(fast, exact):
    """Identical up to FMA/fusion reassociation across jit graphs."""
    scale = max(np.abs(exact).max(), 1e-300)
    np.testing.assert_allclose(fast, exact, atol=2e-15 * scale, rtol=0)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"ZD_qPk_fix_to_mean": 1},
        {"ZD_k_cutoff": 2.0},
        {"ZD_qdensity": 2},
        {"ZD_qonemode": 1, "ZD_one_mode": [2, 1, -1]},
    ],
)
def test_fast_equals_exact(kw):
    param, Pk, cfg, tables = make_setup(ppd=12, **kw)
    fast = np.asarray(synthesize_full_fast(cfg, tables))
    exact = full_grid(cfg, tables)
    assert_same(fast, exact)


def test_fast_gen_phi_and_input_phi():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_f_NL=10.0)
    fast = np.asarray(synthesize_full_fast(cfg, tables, gen_phi=True))
    exact = full_grid(cfg, tables, gen_phi=True)
    assert_same(fast, exact)

    rng = np.random.default_rng(5)
    phi = jnp.asarray(rng.normal(size=(8, 8, 8)) + 1j * rng.normal(size=(8, 8, 8)))
    fast = np.asarray(synthesize_full_fast(cfg, tables, phi_k=phi))
    exact = full_grid(cfg, tables, phi_k=phi)
    assert_same(fast, exact)


def test_fast_plt(tmp_path):
    from test_plt import synthetic_table
    from zeldovich.ops import plt as plt_ops
    from zeldovich.ops.modes import SynthConfig, SynthTables
    from zeldovich.utils.params import Parameters
    from zeldovich.utils.power import PowerSpectrum, mode_amplitude_tables
    from pathlib import Path

    table = synthetic_table(16, seed=3)
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
    fast = np.asarray(synthesize_full_fast(cfg, tables))
    exact = full_grid(cfg, tables)
    assert_same(fast, exact)
