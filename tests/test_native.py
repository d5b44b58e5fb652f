"""Native pack/IO runtime vs the numpy fallback."""

import numpy as np
import pytest

from zeldovich import native
from zeldovich.utils.output import OutputWriter, output_dtype, setup_output_dir
from zeldovich.utils.params import Parameters


def make_params(tmp_path, **over):
    d = dict(
        BoxSize=100.0,
        NP=8**3,
        CPD=8,
        ICFormat="RVZel",
        InitialConditionsDirectory=str(tmp_path / "ic"),
        InitialRedshift=49.0,
        ZD_Seed=1,
        ZD_NumBlock=2,
        ZD_Pk_scale=1.0,
        ZD_Pk_norm=0.0,
        ZD_Pk_sigma=1.0,
        ZD_Pk_smooth=0.0,
        ZD_Pk_powerlaw_index=-1.0,
        ZD_Version=2,
    )
    d.update(over)
    return Parameters.from_dict(d)


def test_native_builds():
    assert native.load() is not None, "native packio failed to build/load"


@pytest.mark.parametrize(
    "fmt", ["RVZel", "RVdoubleZel", "Zeldovich", "ZelSimple"]
)
@pytest.mark.parametrize("qplt", [0, 1])
def test_native_matches_numpy(tmp_path, fmt, qplt):
    if qplt and not fmt.startswith("RV"):
        pytest.skip("PLT requires RV formats")
    p_native = make_params(tmp_path / "n", ICFormat=fmt)
    p_fallback = make_params(tmp_path / "f", ICFormat=fmt)
    if qplt:
        # set after validation (the writer only reads the flags; no
        # eigenmode file is needed to test the serialization path)
        for p in (p_native, p_fallback):
            p.qPLT = 1
            p.f_cluster = 0.8

    rng = np.random.default_rng(0)
    narray = 4 if qplt else 2
    slabs = rng.normal(size=(narray, 8, 8)) + 1j * rng.normal(size=(narray, 8, 8))

    setup_output_dir(p_native)
    setup_output_dir(p_fallback)
    wn = OutputWriter(p_native)
    assert wn._native_buf is not None
    wf = OutputWriter(p_fallback, use_native=False)
    assert wf._native_buf is None
    wn.write_slab(3, slabs)
    wf.write_slab(3, slabs)
    wn.close()
    wf.close()

    fn = sorted(p_native.output_path.glob("ic_*"))[0]
    ff = sorted(p_fallback.output_path.glob("ic_*"))[0]
    a = fn.read_bytes()
    b = ff.read_bytes()
    assert a == b, f"{fmt} qplt={qplt}: native bytes differ from numpy"

    assert wn.density_variance == pytest.approx(wf.density_variance, rel=1e-12)
    np.testing.assert_allclose(wn.max_disp, wf.max_disp)


def test_append_direct(tmp_path):
    buf = np.frombuffer(b"hello world!" * 100, dtype=np.uint8).copy()
    path = tmp_path / "out.bin"
    assert native.append(path, buf)
    assert native.append(path, buf, direct=True)
    assert path.read_bytes() == bytes(buf) * 2
