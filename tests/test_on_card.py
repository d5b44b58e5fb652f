"""CLI runs on an NVIDIA GPU against the CPU float64 run (marker ``gpu``).

Run on a GPU host with ``python -m pytest tests -m gpu``; elsewhere these
tests skip.  The work runs in child processes, because this test process
is pinned to the CPU.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def card_env():
    """The environment of a child that runs on the GPU, or a skip."""
    from conftest import CALLER_JAX_PLATFORMS

    if CALLER_JAX_PLATFORMS == "cpu" or shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    if CALLER_JAX_PLATFORMS:
        env["JAX_PLATFORMS"] = CALLER_JAX_PLATFORMS
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("JAX finds no GPU")
    return env


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "df64", "float32"])
def test_cli_on_card_matches_cpu(card_env, tmp_path, dtype):
    ppd = 32
    ref = tmp_path / "cpu"
    cs.run_cli(cs.write_par(tmp_path / "cpu.par", ref, ppd, "RVdoubleZel"),
               "--dtype", "float64", env=cs.cpu_env())
    out = tmp_path / "gpu"
    log = cs.run_cli(cs.write_par(tmp_path / "gpu.par", out, ppd,
                                  "RVdoubleZel"),
                     "--dtype", dtype, env=card_env)
    assert log["platform"] == "gpu"
    errs = cs.compare_ic(ref, out, "RVdoubleZel")
    cs.check_tolerance(errs, cs.TOL[dtype], f"{ppd}^3 {dtype}")
