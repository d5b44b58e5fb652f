"""Multi-device (8-way virtual CPU mesh) parity with the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathlib import Path

from zeldovich.models.pipeline import Zeldovich
from zeldovich.ops import fft
from zeldovich.parallel.mesh import grid_sharding, make_mesh
from zeldovich.parallel.pencil_fft import fft3_sharded, ifft3_sharded
from zeldovich.parallel.synthesis import reflected, synthesize_sharded
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


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_pencil_ifft_matches_dense(mesh_shape):
    mesh = make_mesh(mesh_shape=mesh_shape)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 16, 16, 16)) + 1j * rng.normal(size=(2, 16, 16, 16))
    ga = jax.device_put(jnp.asarray(a), grid_sharding(mesh))
    got = np.asarray(ifft3_sharded(ga, mesh))
    want = np.asarray(fft.ifft3(jnp.asarray(a), axes=(1, 2, 3)))
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())

    got_f = np.asarray(fft3_sharded(ga, mesh))
    want_f = np.asarray(fft.fft3(jnp.asarray(a), axes=(1, 2, 3)))
    np.testing.assert_allclose(got_f, want_f, atol=1e-10 * np.abs(want_f).max())


def test_reflected():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 6, 8))
    got = np.asarray(reflected(jnp.asarray(a)))
    n0, n1, n2 = a.shape
    want = a[(-np.arange(n0)) % n0][:, (-np.arange(n1)) % n1][
        :, :, (-np.arange(n2)) % n2
    ]
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_sharded_synthesis_matches_single():
    from zeldovich.ops.modes import synthesize_slab

    param = make_params(ppd=16)
    model = Zeldovich(param)
    mesh = make_mesh(mesh_shape=(4, 2))
    got = np.asarray(synthesize_sharded(model.cfg, model.tables, mesh))
    # bit-identical to the single-device elementwise kernel
    want = np.asarray(synthesize_slab(0, 16, model.cfg, model.tables))
    np.testing.assert_array_equal(got, want)
    # and matches the half-space fast path up to FMA reassociation
    fast = np.asarray(model.kspace())
    np.testing.assert_allclose(got, fast, atol=2e-15 * np.abs(fast).max(), rtol=0)


@pytest.mark.slow
def test_sharded_end_to_end_matches_single():
    param = make_params(ppd=16)
    model = Zeldovich(param)
    mesh = make_mesh(mesh_shape=(2, 2), devices=jax.devices()[:4])
    got = np.asarray(model.xspace_sharded(mesh))
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


@pytest.mark.slow
def test_sharded_f_NL_matches_single():
    param = make_params(ppd=16, ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)
    model = Zeldovich(param)
    mesh = make_mesh(mesh_shape=(4, 2))
    got = np.asarray(model.xspace_sharded(mesh))
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_jit_end_to_end_sharded_compiles_once():
    param = make_params(ppd=16)
    model = Zeldovich(param)
    mesh = make_mesh(mesh_shape=(4, 2))

    @jax.jit
    def step(tables):
        from zeldovich.parallel.pencil_fft import ifft3_sharded
        from zeldovich.parallel.synthesis import synthesize_sharded

        k = synthesize_sharded(model.cfg, tables, mesh, dtype=model.dtype)
        return ifft3_sharded(k, mesh)

    out = step(model.tables)
    np.testing.assert_allclose(
        np.asarray(out),
        np.asarray(model.xspace()),
        atol=1e-11 * float(jnp.abs(out).max()),
    )


@pytest.mark.slow
def test_sharded_pair_matches_single():
    """Complex-free sharded path == complex single-device path."""
    param = make_params(ppd=16)
    import jax.numpy as jnp

    model = Zeldovich(param, dtype=jnp.float64)
    mesh = make_mesh(mesh_shape=(4, 2))
    pair = np.asarray(model.xspace_pair_sharded(mesh))
    got = pair[:, 0] + 1j * pair[:, 1]
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


@pytest.mark.slow
def test_sharded_pair_f_NL():
    param = make_params(ppd=16, ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)
    import jax.numpy as jnp

    model = Zeldovich(param, dtype=jnp.float64)
    mesh = make_mesh(mesh_shape=(2, 2), devices=jax.devices()[:4])
    pair = np.asarray(model.xspace_pair_sharded(mesh))
    got = pair[:, 0] + 1j * pair[:, 1]
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


@pytest.mark.slow
def test_sharded_plt_matches_single():
    """PLT eigenmode gathers (tables.eig) inside shard_map."""
    param = make_params(
        ppd=16,
        ZD_qPLT=1,
        ZD_PLT_filename=str(ASSETS / "eigmodes128"),
        ZD_qPLT_rescale=1,
        ZD_PLT_target_z=5.0,
    )
    model = Zeldovich(param)
    mesh = make_mesh(mesh_shape=(4, 2))
    got = np.asarray(model.xspace_sharded(mesh))
    assert got.shape[0] == 4  # velocity arrays present
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())
    # complex-free sharded twin
    pair = np.asarray(model.xspace_pair_sharded(mesh))
    np.testing.assert_allclose(
        pair[:, 0] + 1j * pair[:, 1], want, atol=1e-11 * np.abs(want).max()
    )


@pytest.mark.slow
def test_sharded_qdensity2_matches_single():
    param = make_params(ppd=16, ZD_qdensity=2)
    model = Zeldovich(param)
    assert param.narray == 1
    mesh = make_mesh(mesh_shape=(2, 4))
    got = np.asarray(model.xspace_sharded(mesh))
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


@pytest.mark.slow
def test_sharded_k_cutoff_matches_single():
    param = make_params(ppd=16, ZD_k_cutoff=2.0)
    model = Zeldovich(param)
    mesh = make_mesh(mesh_shape=(4, 2))
    got = np.asarray(model.xspace_sharded(mesh))
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


@pytest.mark.slow
def test_sharded_qoneslab_output(tmp_path):
    """qoneslab through the sharded compute + streamed output."""
    from zeldovich.utils.output import OutputWriter, setup_output_dir
    from zeldovich.utils.streamio import stream_xspace

    outs = {}
    for mode in ("single", "sharded"):
        param = make_params(
            ppd=16,
            ZD_qoneslab=3,
            InitialConditionsDirectory=str(tmp_path / mode),
        )
        model = Zeldovich(param)
        setup_output_dir(param)
        writer = OutputWriter(param)
        if mode == "sharded":
            x = model.xspace_sharded(make_mesh(mesh_shape=(4, 2)))
        else:
            x = model.xspace()
        stream_xspace(x, writer)
        files = sorted(param.output_path.glob("ic_*"))
        assert len(files) == 1  # only slab 3 written
        outs[mode] = files[0].read_bytes()
    assert outs["single"] == outs["sharded"]


@pytest.mark.parametrize(
    "mesh_shape",
    [
        (4, 2),
        # the transposed mesh is ~6 s and exercises the same code path;
        # keep one shape in the fast tier
        pytest.param((2, 4), marks=pytest.mark.slow),
    ],
)
def test_pencil_final_matches_dense(mesh_shape):
    """The 2-transpose (pencil-layout-output) transform: same global array."""
    from zeldovich.parallel.pencil_fft import ifft3_sharded_final
    from zeldovich.parallel.pencil_mmfft import ifft3_pair_sharded_final

    mesh = make_mesh(mesh_shape=mesh_shape)
    rng = np.random.default_rng(2)
    a = rng.normal(size=(2, 16, 16, 16)) + 1j * rng.normal(size=(2, 16, 16, 16))
    ga = jax.device_put(jnp.asarray(a), grid_sharding(mesh))
    got = np.asarray(ifft3_sharded_final(ga, mesh))
    want = np.asarray(fft.ifft3(jnp.asarray(a), axes=(1, 2, 3)))
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())

    pair = jnp.stack([jnp.asarray(a.real), jnp.asarray(a.imag)], axis=0)
    from jax.sharding import NamedSharding, PartitionSpec as P

    gp = jax.device_put(pair, NamedSharding(mesh, P(None, None, "y", "z", None)))
    gotp = np.asarray(ifft3_pair_sharded_final(gp, mesh))
    np.testing.assert_allclose(
        gotp[0] + 1j * gotp[1], want, atol=1e-10 * np.abs(want).max()
    )


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"ZD_qdensity": 2},
        {"ZD_k_cutoff": 2.0},
        {"ZD_qonemode": 1, "ZD_one_mode": [2, 1, 3]},
        # ky=0 one-mode: the in-plane mirror case pk_effective_half_src
        # exists for (the zero rules are not reflection-symmetric)
        {"ZD_qonemode": 1, "ZD_one_mode": [-2, 0, 3]},
        {
            "ZD_qPLT": 1,
            "ZD_PLT_filename": str(ASSETS / "eigmodes128"),
            "ZD_qPLT_rescale": 1,
            "ZD_PLT_target_z": 5.0,
        },
    ],
    ids=["plain", "density", "k_cutoff", "onemode", "onemode_ky0", "plt"],
)
def test_sharded_half_matches_incore_half(extra):
    """The fused 2-collective sharded half-spectrum step == in-core half."""
    param = make_params(ppd=16, **extra)
    model = Zeldovich(param, dtype=jnp.float32)
    want = np.asarray(model.xspace_half_pair())
    assert np.abs(want).max() > 0  # guard against vacuous all-zero compares
    for mesh_shape in ((4, 2), (2, 4)):
        got = np.asarray(
            model.xspace_half_pair_sharded(make_mesh(mesh_shape=mesh_shape))
        )
        np.testing.assert_allclose(
            got, want, atol=1e-5 * max(np.abs(want).max(), 1e-30), rtol=0
        )


def test_sharded_half_zplanes_layout():
    """zplanes=True returns the same global array, z-planes per device."""
    param = make_params(ppd=16)
    model = Zeldovich(param, dtype=jnp.float32)
    mesh = make_mesh(mesh_shape=(4, 2))
    want = np.asarray(model.xspace_half_pair_sharded(mesh))
    got_arr = model.xspace_half_pair_sharded(mesh, zplanes=True)
    np.testing.assert_allclose(
        np.asarray(got_arr), want, atol=1e-6 * np.abs(want).max(), rtol=0
    )
    # every device holds whole z-planes: shard index splits only axis -2
    for s in got_arr.addressable_shards:
        idx = s.index
        assert idx[-1] == slice(None, None, None) or idx[-1].start is None
        assert s.data.shape[-1] == param.ppd
