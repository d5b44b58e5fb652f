"""Benchmark: IC generation throughput on one NVIDIA GPU.

Times the route the CLI takes by default (``python -m zeldovich``): mode
synthesis plus ``jnp.fft`` for float32 and float64, the real-pair
two-float route for ``df64``.  Prints ONE JSON line:

  {"metric": ..., "value": N, "unit": "Mpart/sec", "card": ..., ...}

``value`` is end to end: the device step plus the device->host fetch and
particle serialization to ic_* files (the walltime the reference's final
"Mpart/sec" print covers, src/zeldovich.cpp:1022-1029), minus one-time
setup and compilation.  The device step alone is ``compute_mpart_per_sec``,
timed by an in-jit chain (utils/timers.chain_seconds).  The card's name
and power limit come from nvidia-smi.  Without a GPU it exits 2.

Env: BENCH_PPD (default 512), BENCH_DTYPE (float64|float32|df64, default
float64, the CLI's default), BENCH_PLT=1 (the example.par PLT
configuration), BENCH_E2E=0 (skip the output stage), BENCH_OUTDIR
(default: bench_out in the checkout).
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card() -> str:
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else ""


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)  # u64 RNG limbs
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from zeldovich.models import pipeline
    from zeldovich.ops.modes_fast import synthesize_full_fast
    from zeldovich.utils.backend import enable_compilation_cache
    from zeldovich.utils.params import Parameters
    from zeldovich.utils.timers import chain_seconds

    enable_compilation_cache()
    ppd = int(os.environ.get("BENCH_PPD", "512"))
    dtype_name = os.environ.get("BENCH_DTYPE", "float64")
    plt = os.environ.get("BENCH_PLT") == "1"
    assets = ROOT / "zeldovich" / "assets"
    cfg_dict = dict(
        BoxSize=720.0, NP=ppd**3, CPD=ppd, ICFormat="RVZel",
        InitialConditionsDirectory=os.environ.get(
            "BENCH_OUTDIR", str(ROOT / "bench_out")),
        InitialRedshift=49.0, ZD_Seed=12346, ZD_NumBlock=2,
        ZD_Pk_scale=1.0, ZD_Pk_norm=8.0, ZD_Pk_sigma=0.0210839935761,
        ZD_Pk_smooth=0.0, ZD_Pk_filename=str(assets / "wmap1new.pow"),
        ZD_Version=2,
    )
    if plt:
        cfg_dict.update(ZD_qPLT=1, ZD_PLT_filename=str(assets / "eigmodes128"),
                        ZD_qPLT_rescale=0, ZD_PLT_target_z=5.0)
    param = Parameters.from_dict(cfg_dict)
    dtype = jnp.float32 if dtype_name == "float32" else jnp.float64
    model = pipeline.Zeldovich(param, dtype=dtype)
    cfg, tables = model.cfg, model.tables

    if dtype_name == "df64":
        pair = True
        step = model.xspace_half_df64
        x0 = model.pk_eff

        def fwd(pk):
            return pipeline._half_df64_forward(cfg, tables, pk)
    else:
        pair = False
        step = model.xspace
        x0 = tables.pk_n2

        def fwd(pk_n2):
            t = dataclasses.replace(tables, pk_n2=pk_n2)
            return pipeline._ifft_all(synthesize_full_fast(cfg, t, dtype))

    seconds, _ = chain_seconds(fwd, x0, reps=6, trials=3)
    result = {
        "ppd": ppd, "dtype": dtype_name, "plt": plt,
        "route": "pair-df64" if pair else "complex",
        "compute_seconds": seconds,
        "compute_mpart_per_sec": param.np / 1e6 / seconds,
    }
    value, stage = result["compute_mpart_per_sec"], "device step"
    if os.environ.get("BENCH_E2E", "1") != "0":
        from zeldovich.utils.output import OutputWriter, setup_output_dir
        from zeldovich.utils.streamio import stream_xspace

        jax.block_until_ready(step())  # compiled and warm
        setup_output_dir(param)
        writer = OutputWriter(param)
        t0 = time.perf_counter()
        stream_xspace(step(), writer, pair=pair)
        e2e = time.perf_counter() - t0
        shutil.rmtree(param.output_path, ignore_errors=True)
        result.update(e2e_seconds=e2e, e2e_out_gb=writer.bytes_written / 1e9)
        value, stage = param.np / 1e6 / e2e, "end to end incl. output"
    print(json.dumps({
        "metric": (f"IC generation throughput ({ppd}^3, {dtype_name}"
                   f"{', PLT' if plt else ''}, {stage})"),
        "value": value,
        "unit": "Mpart/sec",
        "card": card(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **result,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
