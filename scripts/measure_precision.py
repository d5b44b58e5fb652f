"""Measure the f32-path displacement error vs the CPU f64 reference.

Runs the real-pair route's fused half-spectrum step at BENCH_PPD
(default 128) on the default backend (the GPU, or the CPU), fetches the
result, and compares against the float64 complex pipeline computed on the
CPU in a subprocess.  Used to quantify the ZT_FFT_PRECISION ladder: run
once per precision setting.

    ZT_FFT_PRECISION=highest python scripts/measure_precision.py
    ZT_FFT_PRECISION=high    python scripts/measure_precision.py
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

PPD = int(os.environ.get("BENCH_PPD", "128"))
REPO = Path(__file__).resolve().parent.parent


def params_dict():
    return dict(
        BoxSize=720.0,
        NP=PPD**3,
        CPD=PPD,
        ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/mp_ic",
        InitialRedshift=49.0,
        ZD_Seed=12346,
        ZD_NumBlock=2,
        ZD_Pk_scale=1.0,
        ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.0210839935761,
        ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(REPO / "zeldovich/assets/wmap1new.pow"),
        ZD_Version=2,
    )


REF_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.path.insert(0, %(repo)r)
from zeldovich.models.pipeline import Zeldovich
from zeldovich.utils.params import Parameters
param = Parameters.from_dict(json.loads(%(params)r))
x = np.asarray(Zeldovich(param, dtype=jnp.float64).xspace())
np.save(%(out)r, np.stack([x.real, x.imag], axis=1))
"""


def main():
    import time

    with tempfile.TemporaryDirectory() as td:
        ref_path = os.path.join(td, "ref.npy")
        env = dict(os.environ)
        env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        code = REF_CHILD % dict(
            repo=str(REPO), params=json.dumps(params_dict()), out=ref_path
        )
        subprocess.run([sys.executable, "-c", code], env=env, check=True)
        want = np.load(ref_path)

        import jax

        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        sys.path.insert(0, str(REPO))
        from zeldovich.models.pipeline import Zeldovich
        from zeldovich.utils.params import Parameters

        param = Parameters.from_dict(params_dict())
        model = Zeldovich(param, dtype=jnp.float32)
        t0 = time.perf_counter()
        got = np.asarray(model.xspace_half_pair())
        dt = time.perf_counter() - t0
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        print(
            json.dumps(
                {
                    "ppd": PPD,
                    "precision": __import__(
                        "zeldovich.ops.mmfft", fromlist=["precision_name"]
                    ).precision_name(),
                    "platform": jax.devices()[0].platform,
                    "max_abs_err": float(err),
                    "rel_err": float(err / scale),
                    "first_step_seconds": dt,
                }
            )
        )


if __name__ == "__main__":
    main()
