#!/usr/bin/env python3
"""Drive the IC generator end to end on NVIDIA GPUs and check its output.

    python chip_smoke.py           # one card: phases 1-5 below
    python chip_smoke.py --four    # four cards: the sharded paths only

One card:

1. Route timings at 512^3 (chain timing, plus each step's
   ``memory_analysis``): the complex route (synthesis + ``jnp.fft``)
   against the real-pair half-spectrum route, for float32, float32 PLT
   and float64 PLT; for float64 also the pair route with Ozaki int8
   transforms against native f64 dots.  Then the stages of the default
   route at 512^3 float32, each beside its bytes / 3.35 TB/s floor.
2. float64 parity at 128^3: the CLI on ``example.par`` (PLT, written as
   RVdoubleZel) on the card against the same run in a CPU child process;
   displacements and velocities within 1e-10 of their rms.
3. float32 and ``--dtype df64`` at 128^3 against that CPU float64 output,
   within 1e-4 and 1e-6 of the rms.
4. 512^3 PLT through the CLI in float32 and float64 (RVZel, 4.3 GB each):
   QA statistics, float32 against float64 within 1e-4 of the rms, and a
   float64 rerun that must give byte-identical ``ic_*`` files.
5. ``--out-of-core`` at 512^3 with at least 4 slabs, default route and
   ``--pair``, against the in-core float64 output (byte-identical, or
   within 1e-10 of the rms beyond the float32 storage rounding).

Four cards (``--four``): the one-card float64 512^3 PLT run, then
``--sharded`` (one process, a 2x2 mesh) and ``--distributed`` (four
processes, one card each, coordinator on localhost), each compared with
the one-card output.

Every CLI run is a child process, one at a time, so one JAX process holds
a card at once; this process keeps JAX from preallocating.  A phase that
fails is reported and the script exits 1 after the remaining phases,
without the ``ok`` line.  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "smoke_out"
EXAMPLE = ROOT / "example.par"
ASSETS = ROOT / "zeldovich" / "assets"

#: grid sizes of the parity phases and of the real-size phases
PARITY_PPD = 128
REAL_PPD = 512

#: max |error| / rms of the reference, per compared dtype
TOL = {"float64": 1e-10, "df64": 1e-6, "float32": 1e-4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
GPU = "gpu"  # the platform every timed or compared run must report

_RVZEL = np.dtype({
    "names": ["i", "j", "k", "displ", "vel"],
    "formats": ["<u2", "<u2", "<u2", "<3f4", "<3f4"],
    "offsets": [0, 2, 4, 8, 20],
    "itemsize": 32,
})
_RVDOUBLEZEL = np.dtype({
    "names": ["i", "j", "k", "displ", "vel"],
    "formats": ["<u2", "<u2", "<u2", "<3f8", "<3f8"],
    "offsets": [0, 2, 4, 8, 32],
    "itemsize": 56,
})
IC_DTYPES = {"RVZel": _RVZEL, "RVdoubleZel": _RVDOUBLEZEL}


class PhaseError(RuntimeError):
    """A check of the smoke run failed."""


# -- pure helpers (tested on the CPU) -----------------------------------


def ic_files(outdir) -> list[Path]:
    """The ``ic_<n>`` files of an output directory, in file-number order."""
    files = [f for f in Path(outdir).glob("ic_*") if f.name[3:].isdigit()]
    return sorted(files, key=lambda f: int(f.name[3:]))


def read_ic(path, icformat: str) -> np.ndarray:
    """Decode one RVZel / RVdoubleZel file into a structured array."""
    dt = IC_DTYPES[icformat]
    size = Path(path).stat().st_size
    if size % dt.itemsize:
        raise PhaseError(f"{path}: {size} bytes is not whole {icformat} records")
    return np.fromfile(path, dtype=dt)


def compare_ic(ref_dir, got_dir, icformat: str, storage_rounding=False) -> dict:
    """Max |got - ref| over the rms of ref, for displ and vel.

    Lattice indices must match exactly.  With ``storage_rounding`` each
    difference is first reduced by one spacing of the stored float type
    at the reference value: two float64 results that agree to far below
    the storage precision may still round to neighbouring float32 values.
    """
    ref_files, got_files = ic_files(ref_dir), ic_files(got_dir)
    if not ref_files:
        raise PhaseError(f"no ic_* files in {ref_dir}")
    if [f.name for f in ref_files] != [f.name for f in got_files]:
        raise PhaseError(f"ic_* file sets differ: {ref_dir} vs {got_dir}")
    n = 0
    sumsq = {"displ": 0.0, "vel": 0.0}
    maxerr = {"displ": 0.0, "vel": 0.0}
    for fa, fb in zip(ref_files, got_files):
        a, b = read_ic(fa, icformat), read_ic(fb, icformat)
        if a.shape != b.shape:
            raise PhaseError(f"{fb.name}: {b.shape} records, want {a.shape}")
        for key in ("i", "j", "k"):
            if not np.array_equal(a[key], b[key]):
                raise PhaseError(f"{fb.name}: lattice index {key} differs")
        n += a.size
        for key in maxerr:
            va, vb = a[key], b[key]
            err = np.abs(vb.astype(np.float64) - va.astype(np.float64))
            if storage_rounding:
                err = np.maximum(err - np.spacing(np.abs(va)), 0.0)
            if a.size:
                maxerr[key] = max(maxerr[key], float(err.max()))
            sumsq[key] += float(np.sum(np.square(va, dtype=np.float64)))
    out = {}
    for key in maxerr:
        rms = (sumsq[key] / (3 * n)) ** 0.5 if n else 0.0
        if not rms > 0.0:
            raise PhaseError(f"reference {key} rms is {rms}")
        out[key] = maxerr[key] / rms
    return out


def check_tolerance(errors: dict, tol: float, what: str) -> str:
    """Raise PhaseError unless every relative error is within ``tol``."""
    worst = max(errors.values())
    line = (f"{what}: max error / rms displ {errors['displ']:.3e}, "
            f"vel {errors['vel']:.3e} (tolerance {tol:.0e})")
    if not worst <= tol:
        raise PhaseError(line)
    return line


def hash_ic(outdir) -> dict:
    """sha256 of every ic_* file, by name."""
    out = {}
    for f in ic_files(outdir):
        h = hashlib.sha256()
        with open(f, "rb") as fp:
            for chunk in iter(lambda: fp.read(1 << 24), b""):
                h.update(chunk)
        out[f.name] = h.hexdigest()
    return out


def parse_cli_log(stderr: str) -> dict:
    """The numbers a CLI run prints: phase times, QA stats, memory, packer."""
    out = {"phases": {}}
    for name, sec in re.findall(r"^(.+) took ([0-9.eE+-]+) seconds$",
                                stderr, re.M):
        out["phases"][name] = float(sec)
    pats = {
        "rms": r"rms density variation of the pixels is ([0-9.eE+-]+)",
        "rms_pred": r"P\(k\) prediction of ([0-9.eE+-]+)",
        "peak_gib": r"Peak device memory: ([0-9.]+) GiB",
        "walltime": r"zeldovich took ([0-9.eE+-]+) sec",
    }
    for key, pat in pats.items():
        m = re.search(pat, stderr)
        if m:
            out[key] = float(m.group(1))
    m = re.search(r"Particle packer: (\w+)", stderr)
    out["packer"] = m.group(1) if m else None
    m = re.search(r"Devices: \d+ x .* \((\w+)\)", stderr)
    out["platform"] = m.group(1) if m else None
    return out


def check_qa(log: dict, what: str) -> str:
    """The run's QA statistics: finite, and the pixel rms within a factor
    of four of the P(k) prediction (they measure different smoothings)."""
    rms, pred = log.get("rms"), log.get("rms_pred")
    if rms is None or pred is None:
        raise PhaseError(f"{what}: no QA statistics in the log")
    ratio = rms / pred if pred > 0 else float("nan")
    line = f"{what}: rms density {rms:.6f}, P(k) prediction {pred:.6f}"
    if not (np.isfinite(rms) and rms > 0 and 0.25 < ratio < 4.0):
        raise PhaseError(line)
    return line


def write_par(path, outdir, ppd: int, icformat: str = "RVZel") -> Path:
    """``example.par`` at ``ppd``^3 writing ``icformat`` into ``outdir``."""
    over = {
        "NP": str(ppd**3),
        "ICFormat": f'"{icformat}"',
        "InitialConditionsDirectory": f'"{outdir}"',
        "ZD_PLT_filename": f'"{ASSETS / "eigmodes128"}"',
        "ZD_Pk_filename": f'"{ASSETS / "wmap1new.pow"}"',
    }
    lines = []
    for line in EXAMPLE.read_text().splitlines():
        key = line.split("=")[0].strip()
        if "=" in line and not line.lstrip().startswith("#") and key in over:
            line = f"{key} = {over.pop(key)}"
        lines.append(line)
    lines += [f"{k} = {v}" for k, v in over.items()]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


# -- the card ------------------------------------------------------------


def card_lines() -> list[str]:
    """``nvidia-smi`` name and power limit, one line per card."""
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if p.returncode != 0 or not p.stdout.strip():
        raise PhaseError(f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()


def run_cli(par, *args, env=None, timeout=300, tag=""):
    """Run ``python -m zeldovich`` as a child; return its parsed log."""
    cmd = [sys.executable, "-m", "zeldovich", str(par), *args]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if p.returncode != 0:
        raise PhaseError(f"{' '.join(cmd[2:])} exited {p.returncode}:\n"
                         f"{p.stderr[-4000:]}")
    log = parse_cli_log(p.stderr)
    log["process_seconds"] = dt
    return log


def print_run(tag: str, log: dict, card: str):
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in log["phases"].items())
    print(f"[{card}] {tag}: process {log['process_seconds']:.1f} s, "
          f"walltime {log.get('walltime', float('nan')):.3f} s, "
          f"peak device memory {log.get('peak_gib', float('nan')):.3f} GiB, "
          f"packer {log['packer']}; {phases}", flush=True)


def cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return env


def gpu_env(**extra):
    env = dict(os.environ, **extra)
    env.pop("XLA_PYTHON_CLIENT_PREALLOCATE", None)
    return env


# -- phase 1 (runs in a child that holds the card) ----------------------


def _timing_params(ppd: int, qplt: bool):
    from zeldovich.utils.params import Parameters

    d = dict(
        BoxSize=720.0, NP=ppd**3, CPD=375, ICFormat="RVZel",
        InitialConditionsDirectory=str(WORK / "unused"),
        InitialRedshift=49.0, ZD_Seed=12346, ZD_NumBlock=4,
        ZD_Pk_scale=1.0, ZD_Pk_norm=8.0, ZD_Pk_sigma=0.0210839935761,
        ZD_Pk_smooth=0.0, ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
        ZD_Version=2,
    )
    if qplt:
        d.update(ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
                 ZD_PLT_target_z=5.0, ZD_qPLT_rescale=0)
    return Parameters.from_dict(d)


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis n/a"
    gib = 2.0**30
    return (f"args {m.argument_size_in_bytes / gib:.2f} GiB, "
            f"out {m.output_size_in_bytes / gib:.2f} GiB, "
            f"temp {m.temp_size_in_bytes / gib:.2f} GiB")


def route_timings(ppd: int = REAL_PPD):
    """Phase 1: print the route and stage timings (needs the card)."""
    import dataclasses

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from zeldovich.models import pipeline
    from zeldovich.utils.backend import enable_compilation_cache
    from zeldovich.utils.timers import chain_seconds

    enable_compilation_cache()
    card = card_lines()[0]
    half_pair = pipeline._half_pair_forward.__wrapped__
    results = {}
    for name, dtype, qplt in (("float32", jnp.float32, False),
                              ("float32 PLT", jnp.float32, True),
                              ("float64 PLT", jnp.float64, True)):
        model = pipeline.Zeldovich(_timing_params(ppd, qplt), dtype=dtype)
        cfg, tables = model.cfg, model.tables

        def complex_step(pk_n2, cfg=cfg, tables=tables, dtype=dtype):
            from zeldovich.ops.modes_fast import synthesize_full_fast

            t = dataclasses.replace(tables, pk_n2=pk_n2)
            return pipeline._ifft_all(synthesize_full_fast(cfg, t, dtype))

        def pair_step(pk, cfg=cfg, tables=tables, dtype=dtype):
            return half_pair(cfg, tables, pk, dtype)

        variants = [("complex", complex_step, tables.pk_n2),
                    ("pair", pair_step, model.pk_eff)]
        if dtype == jnp.float64:
            variants.append(("pair+ozaki", pair_step, model.pk_eff))
        for route, step, x0 in variants:
            if route == "pair+ozaki":
                os.environ["ZT_OZAKI"] = "1"
            try:
                sec, compiled = chain_seconds(step, x0)
            finally:
                os.environ.pop("ZT_OZAKI", None)
            results[(name, route)] = sec
            print(f"[{card}] route {ppd}^3 {name} {route}: "
                  f"{sec * 1e3:.3f} ms/step, "
                  f"{ppd**3 / sec / 1e6:.1f} Mpart/s; {_mem(compiled)}",
                  flush=True)
        del model
    for name in ("float32", "float32 PLT", "float64 PLT"):
        fast = min((r for r in results if r[0] == name), key=results.get)
        print(f"[{card}] fastest route for {ppd}^3 {name}: {fast[1]}",
              flush=True)
    stage_timings(ppd, card)
    stats = jax.local_devices()[0].memory_stats() or {}
    print(f"[{card}] phase 1 peak device memory "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB", flush=True)


def stage_timings(ppd: int, card: str):
    """Each stage of the default route at ppd^3 float32 beside its floor."""
    import jax
    import jax.numpy as jnp

    from zeldovich.models import pipeline
    from zeldovich.ops import fft
    from zeldovich.ops.modes_fast import synthesize_full_fast
    from zeldovich.utils.timers import host_seconds

    model = pipeline.Zeldovich(_timing_params(ppd, False), dtype=jnp.float32)
    cfg = model.cfg
    synth = jax.jit(lambda t: synthesize_full_fast(cfg, t, jnp.float32))
    grid = synth(model.tables)
    gbytes = grid.size * grid.dtype.itemsize
    stages = [
        ("synthesis (draws + fields + packing)", synth, model.tables, gbytes),
        ("ifft x", jax.jit(lambda g: fft.ifft1(g, axis=3)), grid, 2 * gbytes),
        ("ifft z", jax.jit(lambda g: fft.ifft1(g, axis=2)), grid, 2 * gbytes),
        ("ifft y", jax.jit(lambda g: fft.ifft1(g, axis=1)), grid, 2 * gbytes),
        ("ifft 3-D (the pipeline's)", pipeline._ifft_all, grid, 2 * gbytes),
    ]
    for name, fn, arg, nbytes in stages:
        sec = host_seconds(fn, arg)
        floor = nbytes / HBM_BYTES_PER_S
        print(f"[{card}] stage {ppd}^3 float32 {name}: {sec * 1e3:.3f} ms, "
              f"floor {floor * 1e3:.3f} ms ({nbytes / 1e9:.2f} GB at "
              f"3.35 TB/s), {sec / floor:.2f}x floor", flush=True)


# -- the phases driven from the parent -----------------------------------


def phase_routes(card):
    cmd = [sys.executable, "-c",
           f"import chip_smoke; chip_smoke.route_timings({REAL_PPD})"]
    p = subprocess.run(cmd, cwd=ROOT, env=gpu_env(), capture_output=True,
                       text=True, timeout=480)
    sys.stdout.write(p.stdout)
    if p.returncode != 0:
        raise PhaseError(f"route timings exited {p.returncode}:\n"
                         f"{p.stderr[-4000:]}")


def phase_parity(card):
    """Phases 2 and 3: 128^3 on the card against the CPU float64 run."""
    n = PARITY_PPD
    ref_dir = WORK / "p128_cpu"
    par = write_par(WORK / "p128_cpu.par", ref_dir, n, "RVdoubleZel")
    log = run_cli(par, "--dtype", "float64", env=cpu_env())
    if log["platform"] != "cpu":
        raise PhaseError(f"CPU reference ran on {log['platform']}")
    print_run(f"{n}^3 float64 on the CPU (reference)", log, "CPU")
    failures = []
    try:
        for dtype in ("float64", "float32", "df64"):
            out = WORK / f"p128_{dtype}"
            par = write_par(WORK / f"p128_{dtype}.par", out, n,
                            "RVdoubleZel")
            try:
                log = run_cli(par, "--dtype", dtype, env=gpu_env())
                if log["platform"] != GPU:
                    raise PhaseError(f"{n}^3 {dtype} ran on {log['platform']}")
                print_run(f"{n}^3 {dtype}", log, card)
                errs = compare_ic(ref_dir, out, "RVdoubleZel")
                print(f"[{card}] " + check_tolerance(
                    errs, TOL[dtype], f"{n}^3 {dtype} vs CPU float64"),
                    flush=True)
            except (PhaseError, subprocess.TimeoutExpired) as e:
                failures.append(str(e))
                print(f"FAIL {n}^3 {dtype}: {e}", flush=True)
            finally:
                shutil.rmtree(out, ignore_errors=True)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    if failures:
        raise PhaseError(f"{len(failures)} parity check(s) failed")


def phase_512(card):
    """Phases 4 and 5: 512^3 in-core, rerun, and out-of-core."""
    n = REAL_PPD
    ref = WORK / "r512_f64"
    par = write_par(WORK / "r512_f64.par", ref, n)
    failures = []

    def step(tag, fn):
        try:
            fn()
        except (PhaseError, subprocess.TimeoutExpired) as e:
            failures.append(tag)
            print(f"FAIL {tag}: {e}", flush=True)

    try:
        log = run_cli(par, env=gpu_env())
        print_run(f"{n}^3 float64 (default route)", log, card)
        print(f"[{card}] " + check_qa(log, f"{n}^3 float64"), flush=True)
        ref_hash = hash_ic(ref)

        def f32():
            out = WORK / "r512_f32"
            try:
                log = run_cli(write_par(WORK / "r512_f32.par", out, n),
                              "--dtype", "float32", env=gpu_env())
                print_run(f"{n}^3 float32", log, card)
                print(f"[{card}] " + check_qa(log, f"{n}^3 float32"))
                print(f"[{card}] " + check_tolerance(
                    compare_ic(ref, out, "RVZel"), TOL["float32"],
                    f"{n}^3 float32 vs float64"), flush=True)
            finally:
                shutil.rmtree(out, ignore_errors=True)

        def rerun():
            out = WORK / "r512_f64b"
            try:
                log = run_cli(write_par(WORK / "r512_f64b.par", out, n),
                              env=gpu_env())
                print_run(f"{n}^3 float64 rerun", log, card)
                same = hash_ic(out) == ref_hash
                print(f"[{card}] {n}^3 float64 rerun byte-identical: {same}",
                      flush=True)
                if not same:
                    raise PhaseError("float64 rerun differs")
            finally:
                shutil.rmtree(out, ignore_errors=True)

        def ooc(*extra):
            tag = f"{n}^3 float64 --out-of-core " + " ".join(extra)
            out = WORK / "r512_ooc"
            # 4 PLT arrays x n^2 x 16 B per y-row: slabs of n/8 rows,
            # so 8 slabs per pass
            slab_mb = (4 * 16 * n**3 // 8) >> 20
            try:
                log = run_cli(write_par(WORK / "r512_ooc.par", out, n),
                              "--out-of-core", "--slab-mb", str(slab_mb),
                              *extra,
                              env=gpu_env(), timeout=420)
                print_run(tag, log, card)
                same = hash_ic(out) == ref_hash
                errs = compare_ic(ref, out, "RVZel", storage_rounding=True)
                print(f"[{card}] {tag}: byte-identical to in-core: {same}; "
                      + check_tolerance(errs, TOL["float64"],
                                        "vs in-core beyond f32 rounding"),
                      flush=True)
            finally:
                shutil.rmtree(out, ignore_errors=True)

        step(f"{n}^3 float32", f32)
        step(f"{n}^3 float64 rerun", rerun)
        step(f"{n}^3 out-of-core default route", ooc)
        step(f"{n}^3 out-of-core --pair", lambda: ooc("--pair"))
    finally:
        shutil.rmtree(ref, ignore_errors=True)
    if failures:
        raise PhaseError(f"failed: {', '.join(failures)}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_four(card):
    """--four: --sharded and --distributed at 512^3 against one card."""
    n = REAL_PPD
    ref = WORK / "f512_one"
    failures = []
    try:
        log = run_cli(write_par(WORK / "f512_one.par", ref, n),
                      env=gpu_env(CUDA_VISIBLE_DEVICES="0"))
        print_run(f"{n}^3 float64 on one card", log, card)

        out = WORK / "f512_sharded"
        try:
            log = run_cli(write_par(WORK / "f512_sharded.par", out, n),
                          "--sharded", env=gpu_env())
            print_run(f"{n}^3 float64 --sharded (2x2 mesh)", log, card)
            print(f"[{card}] " + check_tolerance(
                compare_ic(ref, out, "RVZel", storage_rounding=True),
                TOL["float64"], "--sharded vs one card, beyond f32 rounding"),
                flush=True)
        except (PhaseError, subprocess.TimeoutExpired) as e:
            failures.append("--sharded")
            print(f"FAIL --sharded: {e}", flush=True)
        finally:
            shutil.rmtree(out, ignore_errors=True)

        out = WORK / "f512_dist"
        par = write_par(WORK / "f512_dist.par", out, n)
        port = _free_port()
        procs = []
        try:
            t0 = time.perf_counter()
            for i in range(4):
                cmd = [sys.executable, "-m", "zeldovich", str(par),
                       "--distributed", "--coordinator", f"localhost:{port}",
                       "--num-processes", "4", "--process-id", str(i)]
                procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, env=gpu_env(CUDA_VISIBLE_DEVICES=str(i)),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            outs = [p.communicate(timeout=420) for p in procs]
            for p, (_, err) in zip(procs, outs):
                if p.returncode != 0:
                    raise PhaseError(f"process exited {p.returncode}:\n"
                                     f"{err[-4000:]}")
            log = parse_cli_log(outs[0][1])
            log["process_seconds"] = time.perf_counter() - t0
            print_run(f"{n}^3 float64 --distributed (4 processes)", log, card)
            print(f"[{card}] " + check_tolerance(
                compare_ic(ref, out, "RVZel", storage_rounding=True),
                TOL["float64"],
                "--distributed vs one card, beyond f32 rounding"), flush=True)
        except (PhaseError, subprocess.TimeoutExpired) as e:
            failures.append("--distributed")
            print(f"FAIL --distributed: {e}", flush=True)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(out, ignore_errors=True)
    finally:
        shutil.rmtree(ref, ignore_errors=True)
    if failures:
        raise PhaseError(f"failed: {', '.join(failures)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded and distributed "
                    "paths, each against the one-card output")
    args = ap.parse_args(argv)

    if not (ROOT / "zeldovich").is_dir() or not EXAMPLE.is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    # this process only looks at the card: the CLI children hold it
    os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != GPU:
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    card = cards[0]

    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    phases = ([("four", phase_four)] if args.four else
              [("routes", phase_routes), ("parity 128^3", phase_parity),
               ("real size", phase_512)])
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(card)
            status = "ok"
        except (PhaseError, subprocess.TimeoutExpired) as e:
            failed.append(name)
            status = "FAILED"
            print(f"FAIL phase {name}: {e}", flush=True)
        print(f"[{card}] phase {name}: {status} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"[{card}] all phases: {time.perf_counter() - t_all:.1f} s",
          flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
