"""The CPU-checkable parts of chip_smoke.py: decoders, comparisons, log
parsing, parameter files, and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def write_ic(outdir, icformat, nfiles=3, nrec=40, seed=0, perturb=None):
    """Synthetic ic_* files: lattice indices plus random displ/vel."""
    rng = np.random.default_rng(seed)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    recs = []
    for n in range(nfiles):
        rec = np.zeros(nrec, dtype=cs.IC_DTYPES[icformat])
        rec["i"] = n
        rec["j"] = np.arange(nrec) // 8
        rec["k"] = np.arange(nrec) % 8
        rec["displ"] = rng.normal(size=(nrec, 3))
        rec["vel"] = rng.normal(size=(nrec, 3))
        if perturb is not None:
            perturb(n, rec)
        rec.tofile(outdir / f"ic_{n}")
        recs.append(rec)
    return recs


@pytest.mark.parametrize("icformat,itemsize", [("RVZel", 32),
                                               ("RVdoubleZel", 56)])
def test_decoder_round_trip(tmp_path, icformat, itemsize):
    recs = write_ic(tmp_path, icformat)
    assert cs.IC_DTYPES[icformat].itemsize == itemsize
    files = cs.ic_files(tmp_path)
    assert [f.name for f in files] == ["ic_0", "ic_1", "ic_2"]
    for f, want in zip(files, recs):
        got = cs.read_ic(f, icformat)
        np.testing.assert_array_equal(got, want)


def test_decoder_matches_package_formats():
    """The script's own record layouts agree with the writer's."""
    from zeldovich.utils.output import output_dtype

    for name, dt in cs.IC_DTYPES.items():
        assert output_dtype(name) == dt


def test_ic_files_numeric_order(tmp_path):
    for n in (10, 2, 1):
        (tmp_path / f"ic_{n}").write_bytes(b"")
    (tmp_path / "ic_out.log").write_bytes(b"")
    assert [f.name for f in cs.ic_files(tmp_path)] == ["ic_1", "ic_2", "ic_10"]


def test_read_rejects_partial_record(tmp_path):
    (tmp_path / "ic_0").write_bytes(b"\0" * 33)
    with pytest.raises(cs.PhaseError):
        cs.read_ic(tmp_path / "ic_0", "RVZel")


@pytest.mark.parametrize("icformat", ["RVZel", "RVdoubleZel"])
def test_compare_identical_is_zero(tmp_path, icformat):
    write_ic(tmp_path / "a", icformat)
    write_ic(tmp_path / "b", icformat)
    errs = cs.compare_ic(tmp_path / "a", tmp_path / "b", icformat)
    assert errs == {"displ": 0.0, "vel": 0.0}


def test_compare_measures_max_over_rms(tmp_path):
    recs = write_ic(tmp_path / "a", "RVdoubleZel")

    def bump(n, rec):
        if n == 1:
            rec["displ"][5, 2] += 1e-3

    write_ic(tmp_path / "b", "RVdoubleZel", perturb=bump)
    d = np.concatenate([r["displ"] for r in recs])
    rms = np.sqrt(np.mean(d**2))
    errs = cs.compare_ic(tmp_path / "a", tmp_path / "b", "RVdoubleZel")
    assert errs["vel"] == 0.0
    assert errs["displ"] == pytest.approx(1e-3 / rms, rel=1e-9)
    with pytest.raises(cs.PhaseError):
        cs.check_tolerance(errs, cs.TOL["float64"], "bumped")
    assert "bumped" in cs.check_tolerance(errs, 1e-2, "bumped")


def test_compare_storage_rounding(tmp_path):
    """One float32 spacing is forgiven only with storage_rounding."""
    write_ic(tmp_path / "a", "RVZel")

    def ulp(n, rec):
        rec["displ"] = np.nextafter(rec["displ"], np.float32(np.inf))

    write_ic(tmp_path / "b", "RVZel", perturb=ulp)
    raw = cs.compare_ic(tmp_path / "a", tmp_path / "b", "RVZel")
    assert raw["displ"] > cs.TOL["float64"]
    forgiven = cs.compare_ic(tmp_path / "a", tmp_path / "b", "RVZel",
                             storage_rounding=True)
    assert forgiven["displ"] == 0.0


def test_compare_rejects_index_or_file_mismatch(tmp_path):
    write_ic(tmp_path / "a", "RVZel")

    def shift(n, rec):
        rec["k"][0] += 1

    write_ic(tmp_path / "b", "RVZel", perturb=shift)
    with pytest.raises(cs.PhaseError, match="lattice index"):
        cs.compare_ic(tmp_path / "a", tmp_path / "b", "RVZel")
    write_ic(tmp_path / "c", "RVZel", nfiles=2)
    with pytest.raises(cs.PhaseError, match="file sets"):
        cs.compare_ic(tmp_path / "a", tmp_path / "c", "RVZel")


def test_hash_detects_one_bit(tmp_path):
    write_ic(tmp_path / "a", "RVZel")
    write_ic(tmp_path / "b", "RVZel")
    assert cs.hash_ic(tmp_path / "a") == cs.hash_ic(tmp_path / "b")
    raw = bytearray((tmp_path / "b" / "ic_2").read_bytes())
    raw[-1] ^= 1
    (tmp_path / "b" / "ic_2").write_bytes(bytes(raw))
    assert cs.hash_ic(tmp_path / "a") != cs.hash_ic(tmp_path / "b")


LOG = """Generating ICs for ppd = 128
Devices: 1 x NVIDIA H100 80GB HBM3 (gpu)
The rms density variation of the pixels is 0.035931
This could be compared to the P(k) prediction of 0.054313
Particle packer: native
Model setup (P(k), RNG tables, eigenmodes) took 0.330698 seconds
Inverse FFT took 0.100937 seconds
Peak device memory: 12.500 GiB of 60.000 GiB
zeldovich took 4.523 sec for ppd 128 ==> 0.464 Mpart/sec
"""


def test_parse_cli_log():
    log = cs.parse_cli_log(LOG)
    assert log["platform"] == "gpu"
    assert log["packer"] == "native"
    assert log["rms"] == 0.035931 and log["rms_pred"] == 0.054313
    assert log["peak_gib"] == 12.5 and log["walltime"] == 4.523
    assert log["phases"] == {
        "Model setup (P(k), RNG tables, eigenmodes)": 0.330698,
        "Inverse FFT": 0.100937,
    }


def test_check_qa():
    assert "rms density" in cs.check_qa(cs.parse_cli_log(LOG), "run")
    with pytest.raises(cs.PhaseError):
        cs.check_qa({"rms": float("nan"), "rms_pred": 0.05}, "run")
    with pytest.raises(cs.PhaseError):
        cs.check_qa({"rms": 0.5, "rms_pred": 0.05}, "run")
    with pytest.raises(cs.PhaseError):
        cs.check_qa({}, "run")


def test_write_par_reads_back(tmp_path):
    from zeldovich.utils.params import Parameters

    par = cs.write_par(tmp_path / "x.par", tmp_path / "out", 64,
                       "RVdoubleZel")
    p = Parameters.from_file(par)
    assert p.ppd == 64 and p.ICFormat == "RVdoubleZel" and p.qPLT
    assert p.output_path == tmp_path / "out"
    assert p.resolve_path(p.PLT_filename).is_file()


def test_refuses_cpu(tmp_path):
    """On the CPU: non-zero exit and no ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_refuses_outside_checkout(tmp_path):
    """A directory holding only chip_smoke.py: non-zero exit, no ok line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
