"""Command-line driver: ``zeldovich <param_file>``.

Mirrors the reference main() (src/zeldovich.cpp:848-1032): reads the
parameter file, reports the memory plan, runs the (optional) f_NL phi
pass, mode synthesis, inverse FFT and particle output, then prints the
physics QA statistics and throughput.

Extras over the reference CLI:
  --part {1,2}     two-phase run: part 1 synthesizes and checkpoints the
                   k-space state (the reference's PART1/PART2 compile-time
                   split, zeldovich.cpp:835-846); part 2 resumes from it.
  --dtype          float64 (default; matches the reference numerics),
                   float32 (fastest) or df64 (f32 draws + f64-grade
                   two-float transforms).
  --profile DIR    wrap the run in a jax.profiler trace.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="zeldovich", description="Zel'dovich/PLT IC generator in JAX"
    )
    ap.add_argument("param_file", help="ParseHeader-style parameter file")
    ap.add_argument("--part", type=int, choices=(1, 2), default=None)
    ap.add_argument(
        "--dtype",
        choices=("float64", "float32", "df64"),
        default="float64",
        help="float64: full parity; float32: fastest; df64: mixed parity "
        "mode (f32 draw chain + f64-grade int8 two-float transforms, "
        "<1e-6 displacement error; real-pair route)",
    )
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument(
        "--out-of-core",
        action="store_true",
        help="stream slabs through a host staging buffer (grids larger "
        "than device memory; the -DDISK equivalent)",
    )
    ap.add_argument(
        "--backing",
        choices=("ram", "disk"),
        default="ram",
        help="out-of-core staging buffer location",
    )
    ap.add_argument(
        "--slab-mb",
        type=int,
        default=2048,
        help="device-resident slab size for --out-of-core",
    )
    ap.add_argument(
        "--sharded",
        action="store_true",
        help="run the pencil-decomposed pipeline over all local devices",
    )
    ap.add_argument(
        "--pair",
        action="store_true",
        help="take the real-pair (matmul-DFT) compute route instead of "
        "the default complex route (jnp.fft)",
    )
    ap.add_argument(
        "--distributed",
        action="store_true",
        help="multi-host run: jax.distributed over all processes (implies "
        "--sharded); each process writes the output slabs it owns",
    )
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    if args.coordinator is not None:
        args.distributed = True
    if args.distributed:
        args.sharded = True

    t_total = time.perf_counter()

    import jax

    jax.config.update("jax_enable_x64", True)  # u64 RNG limbs
    from .utils.backend import enable_compilation_cache

    enable_compilation_cache()

    if args.distributed:
        from .parallel.multihost import init_distributed

        init_distributed(args.coordinator, args.num_processes, args.process_id)

    import jax.numpy as jnp
    import numpy as np

    from .models.pipeline import Zeldovich
    from .utils.output import OutputWriter, setup_output_dir
    from .utils.params import Parameters
    from .utils.timers import PhaseTimers

    if args.part:
        print(f"This is zeldovich part {args.part}", file=sys.stderr)

    from .utils.parseheader import ParseError
    from .utils.params import ParameterError

    try:
        param = Parameters.from_file(args.param_file)
    except FileNotFoundError as e:
        print(f"Parameter file not found: {e.filename}", file=sys.stderr)
        return 1
    except (ParameterError, ParseError) as e:
        print(f"Invalid parameters: {e}", file=sys.stderr)
        return 1
    print(f"Generating ICs for ppd = {param.ppd}", file=sys.stderr)
    dev = jax.devices()[0]
    print(
        f"Devices: {len(jax.devices())} x {dev.device_kind} ({dev.platform})",
        file=sys.stderr,
    )

    if args.dtype == "df64" and args.part and not args.out_of_core:
        print(
            "--dtype df64 checkpoints via --out-of-core (the fused in-core "
            "step has no materialized k-space boundary)",
            file=sys.stderr,
        )
        return 1
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    itemsize = 16 if args.dtype in ("float64", "df64") else 8

    mem_narray = param.narray + (1 if param.f_NL != 0 else 0)
    gib = (param.ppd / 1024.0) ** 3 * mem_narray * itemsize
    print(
        f"Device-resident k-space state: {gib:5.3f} GiB "
        f"({mem_narray} complex arrays, {args.dtype})",
        file=sys.stderr,
    )
    if param.k_cutoff != 1:
        print(
            f"Using k_cutoff = {param.k_cutoff:f} (effective ppd = "
            f"{int(param.ppd / param.k_cutoff + 0.5)})",
            file=sys.stderr,
        )

    timers = PhaseTimers()
    # PART1/PART2 boundary state: a chunked y-slab directory (in-core) or
    # the staged grid as a disk memmap (out-of-core) -- never a monolithic
    # whole-grid file (utils/checkpoint.py)
    ckpt = param.output_path / "zeldovich.kspace.ckpt"
    ckpt_mm = param.output_path / "zeldovich.kspace.mm"

    profile_ctx = None
    if args.profile:
        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()

    try:
        with timers.phase("Model setup (P(k), RNG tables, eigenmodes)"):
            if args.out_of_core:
                from .models.outofcore import (
                    DistributedOutOfCore,
                    OutOfCoreZeldovich,
                )

                ooc_mesh = None
                if args.sharded:
                    from .parallel.mesh import make_mesh

                    ooc_mesh = make_mesh()
                    print(
                        f"Sharded out-of-core over mesh {dict(ooc_mesh.shape)}",
                        file=sys.stderr,
                    )
                cls = (
                    DistributedOutOfCore
                    if args.distributed and jax.process_count() > 1
                    else OutOfCoreZeldovich
                )
                model = cls(
                    param,
                    dtype="df64" if args.dtype == "df64" else dtype,
                    slab_bytes=args.slab_mb << 20,
                    backing=args.backing,
                    pair=args.pair,
                    mesh=ooc_mesh,
                )
            else:
                model = Zeldovich(param, dtype=dtype)

        if args.part != 2 and not args.distributed:
            setup_output_dir(param)

        if args.out_of_core:
            # streamed run (PART boundary is the staged host buffer)
            with timers.phase("Out-of-core streamed run"):
                if args.part == 1:
                    stage = model.stage_pass1(
                        stage=model.stage_memmap(ckpt_mm, "w+")
                    )
                    stage.flush()
                    print(f"Checkpoint written to {ckpt_mm}", file=sys.stderr)
                elif args.part == 2:
                    model.run(
                        setup_dir=False, stage=model.stage_memmap(ckpt_mm, "r")
                    )
                    model.cleanup_stage_memmap(ckpt_mm)
                else:
                    # distributed: process 0 sets up the dir inside run()
                    model.run(setup_dir=args.distributed)
            if not args.distributed or jax.process_index() == 0:
                timers.report()
                _report_device_memory()
                elapsed = time.perf_counter() - t_total
                print(
                    f"zeldovich took {elapsed:.4g} sec for ppd {param.ppd} "
                    f"==> {param.np / 1e6 / elapsed:.3g} Mpart/sec",
                    file=sys.stderr,
                )
            return 0

        mesh = None
        if args.sharded:
            from .parallel.mesh import make_mesh

            mesh = make_mesh()
            print(
                f"Sharded run over mesh {dict(mesh.shape)}", file=sys.stderr
            )

        from .utils.backend import use_pair_route

        use_pair = use_pair_route(args.dtype, args.pair)

        if args.distributed:
            from .parallel.multihost import replicate, run_multihost

            if args.part == 1:
                # distributed PART1: sharded k-space, per-device shard dump
                with timers.phase("Mode synthesis (+ f_NL phi pass)"):
                    model.tables = replicate(model.tables, mesh)
                    kgrid = (
                        model.kspace_pair_sharded(mesh)
                        if use_pair
                        else model.kspace_sharded(mesh)
                    )
                    kgrid.block_until_ready()
                with timers.phase("Writing k-space checkpoint"):
                    from .utils.checkpoint import save_sharded

                    save_sharded(kgrid, ckpt)
                if jax.process_index() == 0:
                    timers.report()
                    print(f"Checkpoint written to {ckpt}", file=sys.stderr)
                return 0
            kgrid = None
            if args.part == 2:
                with timers.phase("Loading k-space checkpoint"):
                    from .utils.checkpoint import load_sharded

                    kgrid = load_sharded(ckpt, mesh)
                want_nd = 5 if use_pair else 4
                if kgrid.ndim != want_nd:
                    print(
                        f"checkpoint is a {kgrid.ndim}-D grid but this run "
                        f"expects {want_nd}-D (part 1/2 must use the same "
                        "--pair/--dtype mode)",
                        file=sys.stderr,
                    )
                    return 1
            with timers.phase("Distributed sharded run"):
                writer = run_multihost(
                    model, mesh, pair=use_pair,
                    df64=args.dtype == "df64", kgrid=kgrid,
                )
            if args.part == 2 and jax.process_index() == 0:
                from .utils.checkpoint import remove_kspace

                remove_kspace(ckpt)
            if jax.process_index() == 0:
                writer.report(model.Pk)
                timers.report()
                _report_device_memory()
                elapsed = time.perf_counter() - t_total
                print(
                    f"zeldovich took {elapsed:.4g} sec for ppd {param.ppd} "
                    f"({jax.process_count()} processes, "
                    f"{len(jax.devices())} devices) ==> "
                    f"{param.np / 1e6 / elapsed:.3g} Mpart/sec",
                    file=sys.stderr,
                )
            return 0

        if args.part == 2:
            with timers.phase("Loading k-space checkpoint"):
                from .utils.checkpoint import load_kspace

                kgrid = load_kspace(ckpt)
                if mesh is not None:
                    from .parallel.mesh import grid_sharding

                    kgrid = jax.device_put(
                        jnp.asarray(kgrid),
                        grid_sharding(mesh, batch_axes=kgrid.ndim - 3),
                    )
                else:
                    kgrid = jnp.asarray(kgrid)
        else:
            with timers.phase("Mode synthesis (+ f_NL phi pass)"):
                if use_pair and mesh is not None:
                    # fused into xspace_pair_sharded unless checkpointing
                    kgrid = (
                        model.kspace_pair_sharded(mesh)
                        if args.part == 1
                        else None
                    )
                elif use_pair:
                    # full-grid pair k-space only when checkpointing (the
                    # half-spectrum fused step otherwise, see below)
                    kgrid = model.kspace_pair() if args.part == 1 else None
                elif mesh is not None:
                    kgrid = model.kspace_sharded(mesh)
                else:
                    kgrid = model.kspace()
                if kgrid is not None:
                    kgrid.block_until_ready()

        if args.part == 1:
            with timers.phase("Writing k-space checkpoint"):
                from .utils.checkpoint import save_kspace

                save_kspace(kgrid, ckpt)
            timers.report()
            print(f"Checkpoint written to {ckpt}", file=sys.stderr)
            return 0

        with timers.phase("Inverse FFT"):
            if mesh is not None and kgrid is None and args.dtype == "df64":
                x = model.xspace_half_df64_sharded(mesh)
            elif use_pair and mesh is not None and kgrid is None:
                # fused half-spectrum sharded step (2 all-to-alls); falls
                # back to the full-grid pencil path for f_NL/ZD_Version=1
                x = model.xspace_half_pair_sharded(mesh)
            elif use_pair and mesh is not None:
                x = model.xspace_pair_sharded(mesh, kgrid)
            elif use_pair and kgrid is None and args.dtype == "df64":
                x = model.xspace_half_df64()  # mixed parity mode
            elif use_pair and kgrid is None:
                x = model.xspace_half_pair()  # fused fast path
            elif use_pair:
                x = model.xspace_pair(kgrid)
            elif mesh is not None:
                x = model.xspace_sharded(mesh, kgrid)
            else:
                x = model.xspace(kgrid)
            x.block_until_ready()
        del kgrid

        with timers.phase("Output"):
            from .utils.streamio import stream_xspace

            writer = OutputWriter(param)
            stream_xspace(x, writer, pair=use_pair)

        if args.part == 2 and ckpt.exists():
            from .utils.checkpoint import remove_kspace

            remove_kspace(ckpt)

        writer.report(model.Pk)
        timers.report()
        _report_device_memory()
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)

    elapsed = time.perf_counter() - t_total
    print(
        f"zeldovich took {elapsed:.4g} sec for ppd {param.ppd} ==> "
        f"{param.np / 1e6 / elapsed:.3g} Mpart/sec",
        file=sys.stderr,
    )
    return 0


def _report_device_memory():
    """Print the first device's peak memory in use, where jax reports it."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        print(
            f"Peak device memory: {stats['peak_bytes_in_use'] / 2**30:.3f} "
            f"GiB of {stats.get('bytes_limit', 0) / 2**30:.3f} GiB",
            file=sys.stderr,
        )


if __name__ == "__main__":
    sys.exit(main())
