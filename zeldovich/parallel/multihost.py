"""Multi-host (pod-scale) execution and parallel particle output.

The reference is a single process (SURVEY.md section 1: OpenMP only); its
design scale ("100s of billions of particles", README.md:31) is reached by
swapping to disk.  The device-side equivalent is a *global* device mesh
spanning processes (jax.distributed): the pencil-FFT shard_map code is
process-count-agnostic, so the only genuinely multi-host pieces are

  1. resharding the final x-space grid into z-slab layout -- z split over
     EVERY device, (y, x) whole -- so each process holds complete output
     slabs for a contiguous z-range;
  2. parallel particle output: every process pwrites its slabs into the
     shared ic_* files at computed offsets (utils/output.py parallel mode),
     producing the byte-identical image of the reference's serial append
     loop (src/output.cpp:208-212);
  3. a global reduction of the QA statistics (density variance, signed
     componentwise max displacement).

Determinism is free: mode synthesis is a pure function of the global grid
index (ops/modes.py), so the ic_* byte image is invariant to process
count, mesh shape, and device count -- asserted in tests/test_multihost.py.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Initialize jax.distributed (idempotent).

    With no arguments, JAX auto-detects known cluster environments
    (e.g. SLURM); the explicit triple is for manual/test launches.
    """
    # probe without touching the XLA backend (jax.process_count would
    # initialize it, after which initialize() hard-errors)
    if jax.distributed.is_initialized():
        return
    triple = (coordinator, num_processes, process_id)
    if any(v is not None for v in triple) and any(v is None for v in triple):
        raise ValueError(
            "coordinator/num_processes/process_id must be given together "
            f"(got {triple}); auto-detection takes none of them"
        )
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # pragma: no cover - double init
        if "already initialized" not in str(e):
            raise


def zslab_sharding(mesh, pair: bool = False) -> NamedSharding:
    """Output layout: z split over every device, (y, x) locally whole.

    grid [narray, Y, Z, X] (pair: [narray, 2, Y, Z, X]); the z axis is
    partitioned over the flattened ("z", "y") mesh so each device owns
    ppd / n_devices contiguous z-planes -- complete output slabs.
    """
    if pair:
        return NamedSharding(mesh, P(None, None, None, ("z", "y"), None))
    return NamedSharding(mesh, P(None, None, ("z", "y"), None))


def replicate(tree, mesh):
    """Host-local pytree -> globally-replicated jax.Arrays on the mesh.

    Every process must pass identical values (true here: the tables are a
    deterministic function of the seed).
    """
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def xspace_zslabs(model, mesh, pair: bool = False, df64: bool = False):
    """Full sharded forward, resharded to z-slab output layout.

    The pair and df64 paths use the fused half-spectrum step whose final
    all_to_all lands whole z-planes per device directly -- no separate
    resharding collective.
    """
    if df64:
        if model.can_fuse_zplanes:
            return model.xspace_half_df64_sharded(mesh, zplanes=True)
        return jax.device_put(
            model.xspace_half_df64_sharded(mesh), zslab_sharding(mesh, True)
        )
    if pair and model.can_fuse_zplanes:
        return model.xspace_half_pair_sharded(mesh, zplanes=True)
    x = model.xspace_pair_sharded(mesh) if pair else model.xspace_sharded(mesh)
    return jax.device_put(x, zslab_sharding(mesh, pair))


def write_local_slabs(x, writer, pair: bool = False):
    """Write the z-slabs owned by this process's devices (overlapped).

    x: globally z-slab-sharded x-space grid.  One-ahead streaming: shard
    i+1's host copy is in flight while shard i is written (prefetching
    every shard up front would materialize the whole process-local grid
    in host RAM -- exactly what streamio exists to avoid).
    """
    from ..utils.streamio import AsyncSlabWriter, _flush_chunk, _start_host_copy

    shards = sorted(x.addressable_shards, key=lambda s: s.index[-2].start or 0)
    # layout sanity: the local shards must partition a z-range in whole
    # planes (a silently-unsharded z axis would write every shard at z=0)
    zs = [(s.index[-2].start or 0, s.index[-2].stop or x.shape[-2])
          for s in shards]
    for (a0, a1), (b0, b1) in zip(zs, zs[1:]):
        if a1 != b0:
            raise ValueError(f"local shards do not tile z: {zs}")
    aw = AsyncSlabWriter(writer)
    try:
        prev = None
        for s in shards:
            _start_host_copy(s.data)
            if prev is not None:
                _flush_chunk(aw, prev.index[-2].start or 0, prev.data, pair=pair)
            prev = s
        if prev is not None:
            _flush_chunk(aw, prev.index[-2].start or 0, prev.data, pair=pair)
    finally:
        aw.close()
    return writer


def reduce_stats(writer):
    """Combine per-process output statistics into globals (in place)."""
    if jax.process_count() == 1:
        return writer
    from jax.experimental import multihost_utils

    allstats = np.asarray(
        multihost_utils.process_allgather(writer.stats_vector())
    )
    writer.merge_stats(allstats)
    return writer


def barrier(name: str = "zt"):
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def run_multihost(
    model, mesh, pair: bool = False, setup_dir: bool = True,
    df64: bool = False, kgrid=None,
):
    """Distributed full run: sharded compute + parallel per-process output.

    ``kgrid``: optional precomputed sharded k-space grid (the PART2
    restart path, utils/checkpoint.load_sharded) -- the forward then runs
    only the inverse transform.  Returns the (stats-reduced) writer; only
    process 0 should report.
    """
    from ..utils.output import OutputWriter, setup_output_dir

    # tables must be global arrays to enter shard_map over a global mesh
    # (the sharded pair path draws inside shard_map and needs no pk_eff)
    model.tables = replicate(model.tables, mesh)
    if kgrid is not None:
        x = (
            model.xspace_pair_sharded(mesh, kgrid)
            if pair
            else model.xspace_sharded(mesh, kgrid)
        )
        x = jax.device_put(x, zslab_sharding(mesh, pair))
    else:
        x = xspace_zslabs(model, mesh, pair=pair, df64=df64)
    if setup_dir:
        if jax.process_index() == 0:
            setup_output_dir(model.param)
        barrier("output_dir_setup")
    writer = OutputWriter(model.param, parallel=jax.process_count() > 1)
    write_local_slabs(x, writer, pair=pair)
    barrier("output_done")
    return reduce_stats(writer)
