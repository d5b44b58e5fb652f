"""Out-of-core pipeline: grids larger than device memory.

The device-streaming analog of the reference's ``-DDISK`` mode (BlockArray,
src/block_array.cpp; README.md:65-104): the full ``narray * ppd^3`` complex
grid lives in a host staging buffer (RAM, or a disk memmap for beyond-RAM
problems) and the device streams slabs through the same fused kernels:

  pass 1 (y-slabs):  synthesize [narray, By, Z, X] -> inverse FFT over
                     z and x (both fully resident per y-slab) -> stage out.
  pass 2 (z-slabs):  stage in [narray, Y, Bz, X] (the host buffer *is* the
                     y<->z transpose fabric -- numpy strided slicing
                     replaces StoreBlock/LoadBlock's block files) ->
                     inverse FFT over y -> decode + write particles.

The f_NL flow adds a staged phi round trip; mirror-half phi values are
served to the synthesis kernel as a host-side reflected slab (the tuple
form of ``phi_k``), so no global gather is ever needed.

Host<->device traffic is 2 reads + 2 writes of the grid per transform pass
-- the same volume the reference moves to disk, but at PCIe/host-DMA
bandwidth.  Every streaming loop runs one slab ahead: slab i+1's device
compute is dispatched (and its host copy started) before slab i is
materialized on host, and particle serialization happens on a background
writer thread (utils/streamio.py) -- so device compute, device->host DMA,
and pack+IO overlap, unlike the reference's serial write loop
(zeldovich.cpp:666-683).

The staged buffer after pass 1 doubles as the PART1/PART2 checkpoint
(the reference's on-disk block files, zeldovich.cpp:835-846).
"""

from __future__ import annotations

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import mmfft
from ..ops.modes import synthesize_slab
from ..ops.modes_real import synthesize_pair, synthesize_slab_pair
from ..utils.output import OutputWriter, setup_output_dir
from ..utils.streamio import AsyncSlabWriter, _start_host_copy
from .pipeline import Zeldovich


def _stream_to_host(items, sink):
    """Pipeline device results to a host sink one step behind dispatch.

    items: iterator of (key, device_array) whose computation is dispatched
    lazily at iteration; sink(key, host_ndarray) consumes results.  Slab
    i+1's compute (and async host copy) is in flight while slab i is
    materialized and consumed.
    """
    prev = None
    for key, arr in items:
        _start_host_copy(arr)
        if prev is not None:
            sink(prev[0], np.asarray(prev[1]))
        prev = (key, arr)
    if prev is not None:
        sink(prev[0], np.asarray(prev[1]))


@partial(jax.jit, static_argnames=("ny", "cfg", "dtype", "gen_phi"))
def _synth_ifft_zx(y0, ny, cfg, tables, dtype, gen_phi=False, phi_pair=None,
                   D_source=None):
    """Synthesize a y-slab and inverse-FFT it along z and x."""
    k = synthesize_slab(
        y0, ny, cfg, tables, dtype=dtype, gen_phi=gen_phi, phi_k=phi_pair,
        D_source=D_source,
    )
    n = k.shape[-1]
    return jnp.fft.ifftn(k, axes=(2, 3)) * (n * n)


@jax.jit
def _ifft_y(zslab):
    """Inverse FFT along y of a staged z-slab [narray, Y, Bz, X]."""
    return jnp.fft.ifft(zslab, axis=1) * zslab.shape[1]


# -- complex-free (pair) stage kernels -----------------------------------


@partial(jax.jit, static_argnames=("ny", "cfg", "dtype", "gen_phi"))
def _synth_ifft_zx_pair(y0, ny, cfg, tables, dtype, gen_phi=False, phi_pair=None):
    """Pair twin of _synth_ifft_zx: (narray, 2, ny, Z, X)."""
    if gen_phi is False and phi_pair is None:
        k = synthesize_slab_pair(y0, ny, cfg, tables, dtype=dtype)
    else:
        ppd = cfg.ppd
        y = (y0 + jnp.arange(ny))[:, None, None]
        z = jnp.arange(ppd)[None, :, None]
        x = jnp.arange(ppd)[None, None, :]
        k = synthesize_pair(
            y, z, x, cfg, tables, dtype=dtype, gen_phi=gen_phi,
            phi_pair=phi_pair,
        )
    p = jnp.swapaxes(k, 0, 1)  # (2, narray, ny, Z, X)
    for ax in (-2, -1):
        re, im = mmfft.cfft_axis(p[0], p[1], ax, +1)
        p = jnp.stack([re, im])
    return jnp.swapaxes(p, 0, 1)


@jax.jit
def _ifft_y_pair(zslab):
    """Pair twin of _ifft_y: zslab (narray, 2, Y, Bz, X), FFT along Y."""
    p = jnp.swapaxes(zslab, 0, 1)
    re, im = mmfft.cfft_axis(p[0], p[1], -3, +1)
    return jnp.swapaxes(jnp.stack([re, im]), 0, 1)


# -- mixed-precision (df64) stage kernels ---------------------------------
# The --dtype df64 parity mode at out-of-core scale: exact-primitive f32
# synthesis + f64-grade two-float (int8) transforms, staged as float64.
# In-core df64 tops out where the pair intermediates exceed device memory;
# here only one slab of them is ever resident.


def _pair_to_f64(rep, imp):
    f64 = jnp.float64
    return jnp.stack(
        [rep[0].astype(f64) + rep[1].astype(f64),
         imp[0].astype(f64) + imp[1].astype(f64)]
    )


def _f64_to_pair(p):
    hi = p.astype(jnp.float32)
    lo = (p - hi.astype(jnp.float64)).astype(jnp.float32)
    return (hi[0], lo[0]), (hi[1], lo[1])


@partial(jax.jit, static_argnames=("ny", "cfg"))
def _synth_ifft_zx_df64(y0, ny, cfg, tables):
    """df64 twin of _synth_ifft_zx_pair: (narray, 2, ny, Z, X) float64."""
    ppd = cfg.ppd
    y = (y0 + jnp.arange(ny))[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]
    k = synthesize_pair(
        y, z, x, cfg, tables, dtype=jnp.float32, accurate=True
    )
    p = jnp.swapaxes(k, 0, 1)  # (2, narray, ny, Z, X) exact f32
    zero = jnp.zeros_like(p[0])
    rep, imp = (p[0], zero), (p[1], zero)
    for ax in (-2, -1):
        rep, imp = mmfft._cfft_axis_df64(rep, imp, ax, +1)
    return jnp.swapaxes(_pair_to_f64(rep, imp), 0, 1)


@jax.jit
def _ifft_y_df64(zslab):
    """df64 twin of _ifft_y_pair: zslab (narray, 2, Y, Bz, X) float64."""
    p = jnp.swapaxes(zslab, 0, 1)
    rep, imp = _f64_to_pair(p)
    rep, imp = mmfft._cfft_axis_df64(rep, imp, -3, +1)
    return jnp.swapaxes(_pair_to_f64(rep, imp), 0, 1)


@jax.jit
def _fwd_y_phi_nl(zslab, f_NL, inv_n3):
    """phi z-slab: finish inverse FFT (y), apply non-linearity, forward y."""
    phi_x = (jnp.fft.ifft(zslab, axis=1) * zslab.shape[1]).real
    phi_x = (phi_x + f_NL * phi_x * phi_x) * inv_n3
    return jnp.fft.fft(phi_x.astype(zslab.dtype), axis=1)


@partial(jax.jit, static_argnames=())
def _fwd_zx(yslab):
    """Forward FFT along z and x of a phi y-slab [narray, By, Z, X]."""
    return jnp.fft.fftn(yslab, axes=(2, 3))


@jax.jit
def _fwd_y_phi_nl_pair(zslab, f_NL, inv_n3):
    """Pair twin of _fwd_y_phi_nl: zslab (narray, 2, Y, Bz, X)."""
    p = jnp.swapaxes(zslab, 0, 1)
    re, _ = mmfft.cfft_axis(p[0], p[1], -3, +1)
    phi_x = (re + f_NL * re * re) * inv_n3
    re, im = mmfft.cfft_axis(phi_x, jnp.zeros_like(phi_x), -3, -1)
    return jnp.swapaxes(jnp.stack([re, im]), 0, 1)


@jax.jit
def _fwd_zx_pair(yslab):
    """Pair twin of _fwd_zx: yslab (narray, 2, By, Z, X), forward z and x."""
    p = jnp.swapaxes(yslab, 0, 1)
    for ax in (-2, -1):
        re, im = mmfft.cfft_axis(p[0], p[1], ax, -1)
        p = jnp.stack([re, im])
    return jnp.swapaxes(p, 0, 1)


class DistributedOutOfCore:
    """Multi-host out-of-core: per-process host staging shards.

    The host transpose fabric is sharded over PROCESSES along x (the axis
    both FFT passes keep whole on device): each process's staging buffer
    holds [narray(, 2), Y, Z, X/nproc] -- 1/nproc of the grid, so total
    host RAM scales out with the pod.  Per y-slab, pass 1 reshards the
    mesh-sharded result to x-split layout (one collective) and each
    process lands only its own x-columns; pass 2 reassembles global
    z-slabs from the per-process shards (jax.make_array_from_process_
    local_data), inverse-transforms y on the mesh, and reshards to z-slab
    output layout so every process writes exactly the ic_* slabs it owns
    (the parallel pwrite-at-offset writer, utils/output.py).

    The scale mode for grids beyond total-mesh device memory *and*
    beyond one host's RAM.  Slab thickness is
    a multiple of the device count so the output resharding stays even.
    """

    def __init__(self, param, dtype=jnp.float64, slab_bytes=2 << 30,
                 backing: str = "ram", pair: bool = False, mesh=None):
        if mesh is None:
            raise ValueError("DistributedOutOfCore requires a global mesh")
        # the single-host streaming machinery is reused for kernels/layout
        self.inner = OutOfCoreZeldovich(
            param, dtype=dtype, slab_bytes=slab_bytes, backing=backing,
            pair=pair, mesh=mesh,
        )
        self.param = param
        self.mesh = mesh
        self.pair = self.inner.pair
        self.Pk = self.inner.Pk
        ndev = mesh.devices.size
        # even output resharding: every device owns whole z-planes
        q = ndev
        cands = [s for s in range(q, param.ppd + 1, q) if param.ppd % s == 0]
        if not cands:
            raise ValueError(
                f"no slab thickness: ppd={param.ppd} has no multiple-of-"
                f"{q} divisor"
            )
        fitting = [s for s in cands if s <= self.inner.slab]
        self.slab = self.inner.slab = fitting[-1] if fitting else cands[0]
        # this process's x-range under the x-split fabric layout
        shape = self._global_yslab_shape(self.slab)
        idx_map = self._xshard(len(shape)).addressable_devices_indices_map(shape)
        xsl = sorted((sl[-1].start or 0, sl[-1].stop) for sl in idx_map.values())
        self.x0 = xsl[0][0]
        self.x1 = xsl[-1][1]
        for (a0, a1), (b0, b1) in zip(xsl, xsl[1:]):
            if a1 != b0:
                raise ValueError(
                    "process-local x-ranges are not contiguous; use a mesh "
                    "built from jax.devices() order"
                )

    def _global_yslab_shape(self, ny):
        p = self.param
        if self.pair:
            return (p.narray, 2, ny, p.ppd, p.ppd)
        return (p.narray, ny, p.ppd, p.ppd)

    def _xshard(self, ndim):
        """x split over every device, all other axes whole."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = [None] * (ndim - 1) + [("z", "y")]
        return NamedSharding(self.mesh, P(*spec))

    def stage_layout(self):
        p = self.param
        shape, dtype = self.inner.stage_layout()
        return (*shape[:-1], self.x1 - self.x0), dtype

    # -- distributed PART1/PART2 boundary -------------------------------
    # The staging shards ARE the checkpoint: each process memmaps its own
    # x-column range (suffix .p{i}) with a fingerprint sidecar so a
    # restart with a different process/mesh topology fails loudly
    # (ref PART split: src/zeldovich.cpp:835-846).
    def _stage_paths(self, base):
        from pathlib import Path

        base = Path(base)
        p = base.with_name(base.name + f".p{jax.process_index()}")
        return p, p.with_name(p.name + ".meta.json")

    def _stage_meta(self):
        shape, dtype = self.stage_layout()
        return {
            "shape": list(shape),
            "dtype": np.dtype(dtype).str,
            "nproc": jax.process_count(),
            "ndev": int(self.mesh.devices.size),
            "x_range": [int(self.x0), int(self.x1)],
        }

    def stage_memmap(self, path, mode="w+"):
        """Per-process disk stage shard (the distributed checkpoint)."""
        import json

        shape, dtype = self.stage_layout()
        mm_path, meta_path = self._stage_paths(path)
        if mode == "w+":
            mm_path.parent.mkdir(parents=True, exist_ok=True)
            meta_path.write_text(json.dumps(self._stage_meta()))
        else:
            want = self._stage_meta()
            got = json.loads(meta_path.read_text())
            if got != want:
                raise ValueError(
                    f"stage checkpoint mismatch: saved={got} now={want}"
                )
        return np.memmap(mm_path, dtype=dtype, mode=mode, shape=shape)

    def cleanup_stage_memmap(self, path):
        mm_path, meta_path = self._stage_paths(path)
        mm_path.unlink(missing_ok=True)
        meta_path.unlink(missing_ok=True)

    def _alloc_stage(self):
        shape, dtype = self.stage_layout()
        if self.inner.backing == "disk":
            path = self.param.output_path / (
                f"zeldovich.stage.p{jax.process_index()}.mm"
            )
            path.parent.mkdir(parents=True, exist_ok=True)
            return np.memmap(path, dtype=dtype, mode="w+", shape=shape)
        return np.empty(shape, dtype=dtype)

    def _stream_land(self, items, land):
        """One-ahead shard streaming: start host DMA of slab i+1's shards
        while slab i lands into the local staging buffer."""
        from ..utils.streamio import _start_host_copy

        prev = None
        for key, arr in items:
            for s in arr.addressable_shards:
                _start_host_copy(s.data)
            if prev is not None:
                land(*prev)
            prev = (key, arr)
        if prev is not None:
            land(*prev)

    def stage_pass1(self, stage=None):
        """Pass 1: sharded synthesis + z/x iFFT, x-split landing per host."""
        from ..parallel.outofcore import synth_ifft_zx_sharded

        inner = self.inner
        p = self.param
        phi_stage = self._phi_stage() if p.f_NL != 0 else None
        if stage is None:
            stage = self._alloc_stage()
        head = (slice(None), slice(None)) if self.pair else (slice(None),)

        def items():
            # pass-1 results land already x-split (the staging layout)
            for y0 in range(0, p.ppd, self.slab):
                phi_blocks = (
                    self._phi_blocks_global(phi_stage, y0)
                    if phi_stage is not None
                    else None
                )
                yield y0, synth_ifft_zx_sharded(
                    y0, self.slab, inner.cfg, inner.tables, inner.dtype,
                    self.mesh, self.pair, df64=inner.mixed,
                    phi_pair=phi_blocks,
                )

        self._stream_land(
            items(), lambda y0, arr: self._land_yslab(stage, head, y0, arr)
        )
        if phi_stage is not None:
            del phi_stage
            if inner.backing == "disk":
                (p.output_path / (
                    f"zeldovich.phi.p{jax.process_index()}.mm"
                )).unlink(missing_ok=True)
        return stage

    def _land_yslab(self, stage, head, y0, arr):
        for s in arr.addressable_shards:
            xs = s.index[-1]
            stage[
                (*head, slice(y0, y0 + self.slab), slice(None),
                 slice((xs.start or 0) - self.x0, xs.stop - self.x0))
            ] = np.asarray(s.data)

    # -- distributed f_NL phi round trip --------------------------------
    # The reference runs f_NL in DISK mode at any NumBlock
    # (src/zeldovich.cpp:946-959).  Here the phi transpose fabric is
    # x-sharded over processes like the main stage; the one cross-process
    # dependency -- the synthesis kernel needs phi(k) at REFLECTED x
    # indices owned by other processes -- is served by a single jitted
    # global index-map (flip+roll resharded x-split), i.e. one collective
    # permute per y-slab instead of any host-side exchange protocol.
    def _phi_local_shape(self):
        p = self.param
        if self.pair:
            return (1, 2, p.ppd, p.ppd, self.x1 - self.x0)
        return (1, p.ppd, p.ppd, self.x1 - self.x0)

    def _alloc_phi_stage(self):
        shape = self._phi_local_shape()
        dtype = self.inner._fnp if self.pair else self.inner._cnp
        if self.inner.backing == "disk":
            path = self.param.output_path / (
                f"zeldovich.phi.p{jax.process_index()}.mm"
            )
            path.parent.mkdir(parents=True, exist_ok=True)
            return np.memmap(path, dtype=dtype, mode="w+", shape=shape)
        return np.empty(shape, dtype=dtype)

    def _phi_stage(self):
        from ..parallel.outofcore import (
            fwd_y_phi_nl_sharded,
            fwd_zx_sharded,
            synth_ifft_zx_sharded,
        )

        inner = self.inner
        p = self.param
        stage = self._alloc_phi_stage()
        head = (slice(None), slice(None)) if self.pair else (slice(None),)
        nd = len(self._phi_local_shape())
        xsh = self._xshard(nd)

        def synth_items():
            for y0 in range(0, p.ppd, self.slab):
                yield y0, synth_ifft_zx_sharded(
                    y0, self.slab, inner.cfg, inner.tables, inner.dtype,
                    self.mesh, self.pair, gen_phi=True,
                )

        self._stream_land(
            synth_items(),
            lambda y0, arr: self._land_yslab(stage, head, y0, arr),
        )

        f_NL = inner.dtype(p.f_NL)
        inv_n3 = inner.dtype(1.0 / p.ppd**3)
        gshape_z = (*self._phi_local_shape()[:-3], p.ppd, self.slab, p.ppd)

        def z_items():
            for z0 in range(0, p.ppd, self.slab):
                loc = np.ascontiguousarray(
                    stage[(*head, slice(None), slice(z0, z0 + self.slab))]
                )
                garr = jax.make_array_from_process_local_data(
                    xsh, loc, gshape_z
                )
                yield z0, fwd_y_phi_nl_sharded(
                    garr, f_NL, inv_n3, self.mesh, self.pair
                )

        def land_z(z0, arr):
            for s in arr.addressable_shards:
                xs = s.index[-1]
                stage[
                    (*head, slice(None), slice(z0, z0 + self.slab),
                     slice((xs.start or 0) - self.x0, xs.stop - self.x0))
                ] = np.asarray(s.data)

        self._stream_land(z_items(), land_z)

        gshape_y = (*self._phi_local_shape()[:-3], self.slab, p.ppd, p.ppd)

        def y_items():
            for y0 in range(0, p.ppd, self.slab):
                loc = np.ascontiguousarray(
                    stage[(*head, slice(y0, y0 + self.slab))]
                )
                garr = jax.make_array_from_process_local_data(
                    xsh, loc, gshape_y
                )
                yield y0, fwd_zx_sharded(garr, self.mesh, self.pair)

        self._stream_land(
            y_items(),
            lambda y0, arr: self._land_yslab(stage, head, y0, arr),
        )
        return stage  # phi(k), x-split local shard, host-resident

    def _reflect_x(self, garr):
        """Global x index-map a[..., (-i) % n] resharded x-split (one
        collective permute under multi-controller jit)."""
        cache = getattr(self, "_reflect_jit", None)
        if cache is None:
            cache = self._reflect_jit = {}
        f = cache.get(garr.ndim)
        if f is None:
            f = cache[garr.ndim] = jax.jit(
                lambda a: jnp.roll(jnp.flip(a, axis=-1), 1, axis=-1),
                out_shardings=self._xshard(garr.ndim),
            )
        return f(garr)

    def _phi_blocks_global(self, phi_stage, y0):
        """(phi_same, phi_refl) global x-split blocks for a pass-1 y-slab.

        The y and z reflections read only local rows/planes (both axes are
        process-local); the x reflection crosses processes via _reflect_x.
        """
        p = self.param
        ys = np.arange(y0, y0 + self.slab)
        rows = (p.ppd - ys) % p.ppd
        reflz = (-np.arange(p.ppd)) % p.ppd
        xsh3 = self._xshard(3)
        gshape3 = (self.slab, p.ppd, p.ppd)

        def gmake(local):
            return jax.make_array_from_process_local_data(
                xsh3, np.ascontiguousarray(local), gshape3
            )

        if self.pair:
            comp = lambda c: phi_stage[0, c]
            same = tuple(gmake(comp(c)[ys]) for c in (0, 1))
            refl = tuple(
                self._reflect_x(gmake(comp(c)[rows][:, reflz]))
                for c in (0, 1)
            )
            return (same, refl)
        same = gmake(phi_stage[0][ys])
        refl = self._reflect_x(gmake(phi_stage[0][rows][:, reflz]))
        return (same, refl)

    def run(self, setup_dir: bool = True, stage=None):
        from ..parallel.multihost import barrier, reduce_stats
        from ..parallel.outofcore import ifft_y_sharded
        from ..utils.output import OutputWriter, setup_output_dir
        from ..utils.streamio import AsyncSlabWriter, _start_host_copy

        p = self.param
        if setup_dir:
            if jax.process_index() == 0:
                setup_output_dir(p)
            barrier("ooc_output_dir")
        own_stage = stage is None
        if own_stage:
            stage = self.stage_pass1()
        writer = OutputWriter(p, parallel=jax.process_count() > 1)
        aw = AsyncSlabWriter(writer)
        head = (slice(None), slice(None)) if self.pair else (slice(None),)
        nd = len(self._global_yslab_shape(self.slab))
        gshape = (*self._global_yslab_shape(p.ppd)[:-3], p.ppd, self.slab, p.ppd)
        xsh = self._xshard(nd)

        def items():
            for z0 in range(0, p.ppd, self.slab):
                loc = np.ascontiguousarray(
                    stage[(*head, slice(None), slice(z0, z0 + self.slab))]
                )
                garr = jax.make_array_from_process_local_data(xsh, loc, gshape)
                # y transform local; one all_to_all to whole-z-plane layout
                yield z0, ifft_y_sharded(garr, self.mesh, self.pair,
                                         zplanes=True, df64=self.inner.mixed)

        try:
            prev = None
            for z0, arr in items():
                shards = sorted(
                    arr.addressable_shards,
                    key=lambda s: s.index[-2].start or 0,
                )
                for s in shards:
                    _start_host_copy(s.data)
                if prev is not None:
                    self._write_zshards(aw, *prev)
                prev = (z0, shards)
            if prev is not None:
                self._write_zshards(aw, *prev)
        finally:
            aw.close()
        if own_stage and self.inner.backing == "disk":
            # run completed: reclaim this process's staged shard (the
            # reference's quickdelete, src/block_array.cpp:266); a crash
            # keeps it as the resume point
            del stage
            (p.output_path / (
                f"zeldovich.stage.p{jax.process_index()}.mm"
            )).unlink(missing_ok=True)
        barrier("ooc_output_done")
        reduce_stats(writer)
        if jax.process_index() == 0:
            writer.report(self.Pk)
        return writer

    def _write_zshards(self, aw, z0, shards):
        from ..utils.streamio import _flush_chunk

        for s in shards:
            dz0 = s.index[-2].start or 0
            _flush_chunk(aw, z0 + dz0, s.data, pair=self.pair)


class OutOfCoreZeldovich(Zeldovich):
    """Streamed pipeline with a host-resident (or disk-memmapped) grid.

    With ``mesh``, each resident slab is sharded over the device mesh
    (parallel/outofcore.py): the host buffer is the transpose fabric, the
    mesh holds one slab -- grids beyond total-mesh device memory become
    reachable
    (the reference's -DDISK at NumBlock > 2, README.md:98-100).
    """

    def __init__(self, param, dtype=jnp.float64, slab_bytes=2 << 30,
                 backing: str = "ram", pair: bool = False, mesh=None):
        # dtype="df64": the mixed parity mode at streaming scale (exact f32
        # draw chain + f64-grade two-float transforms, float64 staging)
        self.mixed = dtype == "df64"
        if self.mixed:
            dtype = jnp.float64
            pair = True
            if param.version == 1:
                raise NotImplementedError(
                    "df64 requires ZD_Version=2; use --dtype float64 for v1"
                )
            if param.f_NL != 0:
                # The f_NL input-phi pass is not Hermitian-exact, so the
                # exact-primitive f32 draw chain does not apply; run the
                # full-f64 pair kernels instead (same parity) -- mirrors
                # the in-core fallback in pipeline.xspace_half_df64_sharded.
                self.mixed = False
        super().__init__(param, dtype=dtype)
        self.backing = backing
        self.mesh = mesh
        self.pair = bool(pair)
        if pair and param.version == 1:
            raise NotImplementedError("ZD_Version=1 uses the complex path")
        if mesh is not None and param.version == 1:
            raise NotImplementedError("ZD_Version=1 uses the host path")
        itemsize = 16 if dtype == jnp.float64 else 8
        row = param.ppd * param.ppd * param.narray * itemsize
        self.slab = max(1, min(param.ppd, slab_bytes // row))
        if mesh is None:
            while param.ppd % self.slab:
                self.slab -= 1
        else:
            # x-split slab kernels (parallel/outofcore.py): the only grid
            # requirement is ppd % n_devices (x columns and the x-transform
            # z-split); slab thickness just divides ppd.  Validate here so
            # a bad mesh fails at setup, not mid-run.
            n = mesh.devices.size
            if param.ppd % n:
                raise ValueError(
                    f"grid {param.ppd} not divisible by {n} mesh devices"
                )
            while param.ppd % self.slab:
                self.slab -= 1
        self._cnp = np.complex128 if dtype == jnp.float64 else np.complex64
        self._fnp = np.float64 if dtype == jnp.float64 else np.float32

    # -- staging buffer -------------------------------------------------
    def stage_layout(self, narray=None):
        """(shape, numpy dtype) of the host staging buffer."""
        p = self.param
        narray = p.narray if narray is None else narray
        if self.pair:
            return (narray, 2, p.ppd, p.ppd, p.ppd), self._fnp
        return (narray, p.ppd, p.ppd, p.ppd), self._cnp

    def stage_memmap(self, path, mode="w+"):
        """Disk-backed staging buffer at ``path`` (the PART1/2 checkpoint).

        O(1) extra memory at any grid size -- pass 1 streams y-slabs
        straight into it; pass 2 streams z-slabs back out.
        """
        shape, dtype = self.stage_layout()
        return np.memmap(path, dtype=dtype, mode=mode, shape=shape)

    def cleanup_stage_memmap(self, path):
        Path(path).unlink(missing_ok=True)

    def _alloc_stage(self, narray, name="zeldovich.stage"):
        p = self.param
        shape, dtype = self.stage_layout(narray)
        if self.backing == "disk":
            path = p.output_path / f"{name}.mm"
            path.parent.mkdir(parents=True, exist_ok=True)
            return np.memmap(path, dtype=dtype, mode="w+", shape=shape)
        return np.empty(shape, dtype=dtype)

    def _stage_y_sink(self, stage):
        """Sink writing a y-slab into the staging buffer (pair-aware: the
        y axis sits after the (re, im) axis in the pair layout)."""
        head = (slice(None), slice(None)) if self.pair else (slice(None),)

        def sink(y0, h):
            stage[(*head, slice(y0, y0 + self.slab))] = h

        return sink

    # -- phi round trip -------------------------------------------------
    def _phi_stage(self):
        p = self.param
        stage = self._alloc_stage(1, "zeldovich.phi")

        def synth_items():
            for y0 in range(0, p.ppd, self.slab):
                if self.mesh is not None:
                    from ..parallel.outofcore import synth_ifft_zx_sharded

                    out = synth_ifft_zx_sharded(
                        y0, self.slab, self.cfg, self.tables, self.dtype,
                        self.mesh, self.pair, gen_phi=True,
                    )
                elif self.pair:
                    out = _synth_ifft_zx_pair(
                        y0, self.slab, self.cfg, self.tables, self.dtype,
                        gen_phi=True,
                    )
                else:
                    out = _synth_ifft_zx(
                        y0, self.slab, self.cfg, self.tables, self.dtype,
                        gen_phi=True, D_source=self._D_source,
                    )
                yield y0, out

        _stream_to_host(synth_items(), self._stage_y_sink(stage))
        f_NL = self.dtype(p.f_NL)
        inv_n3 = self.dtype(1.0 / p.ppd**3)
        zslice = (
            (slice(None), slice(None))  # [narray, 2, ...]
            if self.pair
            else (slice(None),)
        )

        def z_items():
            fwd = _fwd_y_phi_nl_pair if self.pair else _fwd_y_phi_nl
            for z0 in range(0, p.ppd, self.slab):
                sel = (*zslice, slice(None), slice(z0, z0 + self.slab))
                if self.mesh is not None:
                    from ..parallel.outofcore import fwd_y_phi_nl_sharded

                    yield sel, fwd_y_phi_nl_sharded(
                        stage[sel], f_NL, inv_n3, self.mesh, self.pair
                    )
                else:
                    yield sel, fwd(jnp.asarray(stage[sel]), f_NL, inv_n3)

        _stream_to_host(z_items(), stage.__setitem__)

        def y_items():
            fwd = _fwd_zx_pair if self.pair else _fwd_zx
            for y0 in range(0, p.ppd, self.slab):
                sel = (*zslice, slice(y0, y0 + self.slab))
                if self.mesh is not None:
                    from ..parallel.outofcore import fwd_zx_sharded

                    yield sel, fwd_zx_sharded(stage[sel], self.mesh, self.pair)
                else:
                    yield sel, fwd(jnp.asarray(stage[sel]))

        _stream_to_host(y_items(), stage.__setitem__)
        return stage  # phi(k), full Hermitian grid, host-resident

    def _phi_pair_for_slab(self, phi_stage, y0):
        """(phi_same, phi_refl) local blocks for output y-slab [y0, y0+B)."""
        p = self.param
        ys = np.arange(y0, y0 + self.slab)
        refl = (-np.arange(p.ppd)) % p.ppd
        if self.pair:
            # components: (re, im) tuples of same/reflected-index values
            def take(c, reflected):
                a = phi_stage[0, c]
                if reflected:
                    a = a[(p.ppd - ys) % p.ppd][:, refl][:, :, refl]
                else:
                    a = a[ys]
                return jnp.asarray(a)

            same = (take(0, False), take(1, False))
            rfl = (take(0, True), take(1, True))
            return (same, rfl)
        phi_same = phi_stage[0, ys]
        phi_refl = phi_stage[0][(p.ppd - ys) % p.ppd][:, refl][:, :, refl]
        return (jnp.asarray(phi_same), jnp.asarray(phi_refl))

    # -- main passes ----------------------------------------------------
    def stage_pass1(self, stage=None):
        """Pass 1: synthesis + z/x inverse FFTs, staged to host, [a,y,z,x]."""
        p = self.param
        phi_stage = self._phi_stage() if p.f_NL != 0 else None
        if stage is None:
            stage = self._alloc_stage(p.narray)

        def items():
            for y0 in range(0, p.ppd, self.slab):
                phi_pair = (
                    self._phi_pair_for_slab(phi_stage, y0)
                    if phi_stage is not None
                    else None
                )
                if self.mesh is not None:
                    from ..parallel.outofcore import synth_ifft_zx_sharded

                    out = synth_ifft_zx_sharded(
                        y0, self.slab, self.cfg, self.tables, self.dtype,
                        self.mesh, self.pair, phi_pair=phi_pair,
                        df64=self.mixed,
                    )
                elif self.mixed:
                    out = _synth_ifft_zx_df64(
                        y0, self.slab, self.cfg, self.tables
                    )
                elif self.pair:
                    out = _synth_ifft_zx_pair(
                        y0, self.slab, self.cfg, self.tables, self.dtype,
                        phi_pair=phi_pair,
                    )
                else:
                    out = _synth_ifft_zx(
                        y0, self.slab, self.cfg, self.tables, self.dtype,
                        phi_pair=phi_pair, D_source=self._D_source,
                    )
                yield y0, out

        _stream_to_host(items(), self._stage_y_sink(stage))
        self._drop_phi_stage(phi_stage)
        return stage

    def _drop_phi_stage(self, phi_stage, name="zeldovich.phi"):
        """Release the consumed phi fabric (and its disk file, if any) --
        it is 1/narray of the main stage and must not survive the run."""
        if phi_stage is None:
            return
        del phi_stage
        if self.backing == "disk":
            (self.param.output_path / f"{name}.mm").unlink(missing_ok=True)

    def run(self, setup_dir: bool = True, stage=None) -> OutputWriter:
        p = self.param
        if setup_dir:
            setup_output_dir(p)
        own_stage = stage is None
        if own_stage:
            stage = self.stage_pass1()
        writer = OutputWriter(p)
        aw = AsyncSlabWriter(writer)

        def items():
            for z0 in range(0, p.ppd, self.slab):
                if self.pair:
                    sel = (
                        slice(None), slice(None), slice(None),
                        slice(z0, z0 + self.slab),
                    )
                else:
                    sel = (slice(None), slice(None), slice(z0, z0 + self.slab))
                if self.mesh is not None:
                    from ..parallel.outofcore import ifft_y_sharded

                    # numpy in: jax shards the host slab at dispatch
                    yield z0, ifft_y_sharded(
                        stage[sel], self.mesh, self.pair, df64=self.mixed
                    )
                elif self.mixed:
                    yield z0, _ifft_y_df64(jnp.asarray(stage[sel]))
                elif self.pair:
                    yield z0, _ifft_y_pair(jnp.asarray(stage[sel]))
                else:
                    yield z0, _ifft_y(jnp.asarray(stage[sel]))

        def sink(z0, h):
            from ..utils.streamio import _flush_chunk

            _flush_chunk(aw, z0, h, pair=self.pair)

        try:
            _stream_to_host(items(), sink)
        finally:
            aw.close()
        if own_stage and self.backing == "disk":
            # the run completed: reclaim the staged fabric, like the
            # reference's quickdelete of consumed block files
            # (src/block_array.cpp:266).  A crash leaves it on disk as
            # the resume point (--part 2 / stage=).
            del stage
            (p.output_path / "zeldovich.stage.mm").unlink(missing_ok=True)
        writer.report(self.Pk)
        return writer
