"""Multi-host execution: N-process run is byte-identical to 1-process.

Spawns real OS processes running the real CLI over jax.distributed (CPU
backend, Gloo collectives, 2 virtual devices per process) and compares the
ic_* byte image against the plain single-process pipeline.  Also unit-tests
the parallel (pwrite-at-offset) writer mode against the serial append mode.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from zeldovich.models.pipeline import Zeldovich
from zeldovich.utils.output import OutputWriter, setup_output_dir
from zeldovich.utils.params import Parameters

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"

# every test here spawns real OS processes (or runs a full pipeline);
# CI's fast tier deselects them with -m "not slow"
pytestmark = pytest.mark.slow


def make_params(outdir, ppd=16, **over):
    d = dict(
        BoxSize=100.0,
        NP=ppd**3,
        CPD=ppd,
        ICFormat="RVZel",
        InitialConditionsDirectory=str(outdir),
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


def write_par(path, outdir, ppd=16, **over):
    base = {
        "BoxSize": 100.0,
        "NP": ppd**3,
        "CPD": ppd,
        "ICFormat": '"RVZel"',
        "InitialConditionsDirectory": f'"{outdir}"',
        "InitialRedshift": 49.0,
        "ZD_Seed": 12346,
        "ZD_NumBlock": 2,
        "ZD_Pk_scale": 1.0,
        "ZD_Pk_norm": 8.0,
        "ZD_Pk_sigma": 0.02,
        "ZD_Pk_smooth": 0.0,
        "ZD_Pk_filename": f'"{ASSETS / "wmap1new.pow"}"',
        "ZD_Version": 2,
    }
    base.update(over)
    path.write_text(
        "\n".join(f"{k} = {v}" for k, v in base.items()) + "\n"
    )


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_cli(par, nproc, pid, port, devs_per_proc=2, extra=()):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devs_per_proc}",
    )
    return subprocess.Popen(
        [
            sys.executable,
            "-m",
            "zeldovich",
            str(par),
            "--distributed",
            "--coordinator",
            f"127.0.0.1:{port}",
            "--num-processes",
            str(nproc),
            "--process-id",
            str(pid),
            *extra,
        ],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


def _files_bytes(outdir: Path) -> dict:
    return {
        f.name: f.read_bytes() for f in sorted(outdir.glob("ic_*"))
    } | {f.name: f.read_bytes() for f in sorted(outdir.glob("density*"))}


@pytest.mark.parametrize("nproc", [4])
def test_distributed_matches_single_process(tmp_path, nproc):
    # reference: plain single-process pipeline
    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir)).run()
    ref = _files_bytes(ref_dir)
    assert ref

    # distributed: nproc real processes over a shared output dir
    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir)
    port = _free_port()
    procs = [_spawn_cli(par, nproc, i, port) for i in range(nproc)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    got = _files_bytes(mh_dir)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], f"{name} differs"
    # process 0 reports the reduced global stats
    err0 = outs[0][1]
    assert "rms density variation" in err0
    assert "Mpart/sec" in err0


def test_distributed_pair_matches_single(tmp_path):
    """The complex-free (real-pair) distributed path vs single-process."""
    from zeldovich.utils.output import read_particles

    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir)).run()

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir)
    port = _free_port()
    procs = [
        _spawn_cli(par, 2, i, port, devs_per_proc=4, extra=("--pair",))
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    ref_files = sorted(ref_dir.glob("ic_*"))
    got_files = sorted(mh_dir.glob("ic_*"))
    assert [f.name for f in ref_files] == [f.name for f in got_files]
    for fr, fg in zip(ref_files, got_files):
        ra = read_particles(fr, "RVZel")
        rb = read_particles(fg, "RVZel")
        np.testing.assert_array_equal(ra["i"], rb["i"])
        np.testing.assert_allclose(ra["displ"], rb["displ"], atol=1e-12)
        np.testing.assert_allclose(ra["vel"], rb["vel"], atol=1e-12)


def test_distributed_outofcore_matches_single(tmp_path):
    """Multi-host out-of-core: per-process x-sharded host staging shards.

    4 real processes x 2 virtual devices; each host stages 1/4 of the
    transpose fabric and pwrites the output slabs it owns.  The ic_* byte
    image must equal the plain single-process run.
    """
    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir)).run()
    ref = _files_bytes(ref_dir)
    assert ref

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir)
    port = _free_port()
    # --slab-mb 0 floors at the minimum (multiple-of-ndev) thickness: the
    # 16^3 grid streams in 2 slabs of 8 through 8 global devices
    procs = [
        _spawn_cli(par, 4, i, port, extra=("--out-of-core", "--slab-mb", "0"))
        for i in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    got = _files_bytes(mh_dir)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], f"{name} differs"
    err0 = outs[0][1]
    assert "rms density variation" in err0


def test_distributed_outofcore_f_NL_matches_single(tmp_path):
    """f_NL through the distributed out-of-core phi fabric.

    The reflected-phi blocks cross process boundaries (the x reflection is
    a jitted global index-map); the ic_* byte image must still equal the
    plain single-process run.  Ref: the reference runs f_NL in DISK mode
    at any NumBlock (src/zeldovich.cpp:946-959).
    """
    fnl = dict(ZD_f_NL=25.0, ZD_n_s=0.96, Omega_M=0.3)
    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir, **fnl)).run()
    ref = _files_bytes(ref_dir)
    assert ref

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir, **fnl)
    port = _free_port()
    # disk backing: also exercises the per-process stage/phi memmap files
    procs = [
        _spawn_cli(
            par, 4, i, port,
            extra=("--out-of-core", "--slab-mb", "0", "--backing", "disk"),
        )
        for i in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    got = _files_bytes(mh_dir)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], f"{name} differs"
    # quickdelete: completed runs reclaim every staged memmap shard
    assert not list(mh_dir.glob("*.mm")), list(mh_dir.glob("*.mm"))


def test_distributed_plt_matches_single(tmp_path):
    """Distributed PLT: narray=4 + replicated eigenmode-table gathers."""
    plt = dict(
        ZD_qPLT=1,
        ZD_qPLT_rescale=0,
        ZD_PLT_target_z=5.0,
        ZD_PLT_filename=f'"{ASSETS / "eigmodes128"}"',
    )
    ref_kw = dict(
        ZD_qPLT=1,
        ZD_qPLT_rescale=0,
        ZD_PLT_target_z=5.0,
        ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    )
    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir, **ref_kw)).run()
    ref = _files_bytes(ref_dir)

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir, **plt)
    port = _free_port()
    procs = [_spawn_cli(par, 2, i, port) for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    got = _files_bytes(mh_dir)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], f"{name} differs"


def test_distributed_qdensity_and_file_mapping(tmp_path):
    """qdensity=1 (density file) + CPD < PPD (multi-slab ic_* files)
    through the distributed parallel writer."""
    kw = dict(ZD_qdensity=1, CPD=5)
    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir, **kw)).run()
    ref = _files_bytes(ref_dir)
    assert any(n.startswith("density") for n in ref)
    assert len([n for n in ref if n.startswith("ic_")]) == 5  # CPD < PPD

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir, **kw)
    port = _free_port()
    procs = [_spawn_cli(par, 2, i, port) for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    got = _files_bytes(mh_dir)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], f"{name} differs"


def test_distributed_df64_matches_incore(tmp_path):
    """--dtype df64 --distributed: parity-grade numerics across processes.

    Not byte-compared (different compiled programs round the last f32 bit
    differently; see tests/test_df64_sharded.py) -- the displacements must
    agree with the single-device df64 run to well under the parity bar.
    """
    from zeldovich.utils.output import read_particles

    import jax.numpy as jnp

    ref_dir = tmp_path / "ref"
    param = make_params(ref_dir)
    from zeldovich.utils.streamio import stream_xspace

    setup_output_dir(param)
    model = Zeldovich(param, dtype=jnp.float32)
    w = OutputWriter(param)
    stream_xspace(model.xspace_half_df64(), w, pair=True)
    w.close()

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir)
    port = _free_port()
    procs = [
        _spawn_cli(par, 2, i, port, extra=("--dtype", "df64"))
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    ref_files = sorted(ref_dir.glob("ic_*"))
    got_files = sorted(mh_dir.glob("ic_*"))
    assert [f.name for f in ref_files] == [f.name for f in got_files]
    for fr, fg in zip(ref_files, got_files):
        ra = read_particles(fr, "RVZel")
        rb = read_particles(fg, "RVZel")
        np.testing.assert_array_equal(ra["i"], rb["i"])
        for fld in ("displ", "vel"):
            scale = np.abs(ra[fld]).max()
            assert np.abs(ra[fld] - rb[fld]).max() < 1e-6 * scale


def _run_distributed(par, nproc, extra=(), devs_per_proc=2):
    port = _free_port()
    procs = [
        _spawn_cli(par, nproc, i, port, devs_per_proc=devs_per_proc,
                   extra=extra)
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{err[-3000:]}"
    return outs


def test_distributed_part_restart(tmp_path):
    """In-core distributed PART1 -> all processes exit -> PART2 restart.

    The k-space boundary is a per-device shard dump with a mesh
    fingerprint (utils/checkpoint.save_sharded); the restarted part 2 must
    produce the byte-identical ic_* set (ref: the reference PART split,
    src/zeldovich.cpp:835-846).
    """
    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir)).run()
    ref = _files_bytes(ref_dir)

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir)
    _run_distributed(par, 2, extra=("--part", "1"))
    ckpt = mh_dir / "zeldovich.kspace.ckpt"
    assert (ckpt / "meta.json").exists()
    assert len(list(ckpt.glob("shard_d*.npy"))) == 4  # 2 procs x 2 devices
    _run_distributed(par, 2, extra=("--part", "2"))
    got = _files_bytes(mh_dir)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], f"{name} differs"
    assert not ckpt.exists()  # consumed


def test_distributed_part_restart_mesh_mismatch(tmp_path):
    """A PART2 restart with a different topology must fail loudly."""
    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir)
    _run_distributed(par, 2, extra=("--part", "1"))
    port = _free_port()
    procs = [
        _spawn_cli(par, 4, i, port, devs_per_proc=1, extra=("--part", "2"))
        for i in range(4)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    assert any(p.returncode != 0 for p in procs)
    assert any("checkpoint" in err for _, err in outs)


def test_distributed_outofcore_part_restart(tmp_path):
    """Distributed out-of-core PART1/PART2: per-process stage memmaps."""
    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir)).run()
    ref = _files_bytes(ref_dir)

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir)
    ooc = ("--out-of-core", "--slab-mb", "0")
    _run_distributed(par, 2, extra=(*ooc, "--part", "1"))
    stages = sorted(mh_dir.glob("zeldovich.kspace.mm.p*"))
    assert len(stages) == 4  # 2 memmaps + 2 meta sidecars
    _run_distributed(par, 2, extra=(*ooc, "--part", "2"))
    got = _files_bytes(mh_dir)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name] == ref[name], f"{name} differs"
    assert not list(mh_dir.glob("zeldovich.kspace.mm.p*"))  # consumed


@pytest.mark.parametrize(
    "icformat", ["RVZel", "RVdoubleZel", "Zeldovich", "ZelSimple"]
)
def test_parallel_writer_matches_append(tmp_path, icformat):
    """pwrite-at-offset mode == serial append mode, for every output
    format, incl. CPD < PPD file mapping (output.cpp:208-212)."""
    ppd = 16
    rng = np.random.default_rng(3)
    slabs = rng.normal(size=(ppd, 2, ppd, ppd)) + 1j * rng.normal(
        size=(ppd, 2, ppd, ppd)
    )

    pa = make_params(tmp_path / "a", CPD=5, ZD_qdensity=1, ICFormat=icformat)
    setup_output_dir(pa)
    wa = OutputWriter(pa)
    for z in range(ppd):
        wa.write_slab(z, slabs[z])
    wa.close()

    pb = make_params(tmp_path / "b", CPD=5, ZD_qdensity=1, ICFormat=icformat)
    setup_output_dir(pb)
    wb = OutputWriter(pb, parallel=True)
    for z in np.random.default_rng(0).permutation(ppd):  # any order
        wb.write_slab(int(z), slabs[z])
    wb.close()

    a, b = _files_bytes(pa.output_path), _files_bytes(pb.output_path)
    assert a.keys() == b.keys() and len(a) > 2
    for name in a:
        assert a[name] == b[name], f"{name} differs"


def test_distributed_rvdoublezel_matches_single(tmp_path):
    """A non-default (double-precision) format through the distributed
    writer.  Not byte-compared: RVdoubleZel stores raw f64 displacements,
    and the pencil FFT transforms axes in a different order than the
    single-device ifft3, so the last f64 ulp differs per program."""
    from zeldovich.utils.output import read_particles

    ref_dir = tmp_path / "ref"
    Zeldovich(make_params(ref_dir, ICFormat="RVdoubleZel")).run()

    mh_dir = tmp_path / "mh"
    par = tmp_path / "mh.par"
    write_par(par, mh_dir, ICFormat='"RVdoubleZel"')
    _run_distributed(par, 2)
    ref_files = sorted(ref_dir.glob("ic_*"))
    got_files = sorted(mh_dir.glob("ic_*"))
    assert [f.name for f in ref_files] == [f.name for f in got_files]
    for fr, fg in zip(ref_files, got_files):
        ra = read_particles(fr, "RVdoubleZel")
        rb = read_particles(fg, "RVdoubleZel")
        np.testing.assert_array_equal(ra["i"], rb["i"])
        np.testing.assert_allclose(ra["displ"], rb["displ"], atol=1e-12)
        np.testing.assert_allclose(ra["vel"], rb["vel"], atol=1e-12)
