"""Sharded out-of-core slab kernels: mesh + host staging combined.

Grids beyond the mesh's total device memory (the reference's ``-DDISK`` at
NumBlock > 2, holding 2/NB of the problem resident, README.md:98-100)
stream through the same host staging buffer as models/outofcore.py, but
each resident slab is itself sharded over the device mesh.

Layout: every slab is sharded along x -- the axis the whole pipeline
keeps contiguous (the reference's "skewer" axis, README.md:66-75) -- over
the FLATTENED ("z", "y") mesh.  Mode synthesis is a pure function of the
global index, so each device synthesizes its own x-columns of the full
(y-range x Z) box directly:

  pass 1: device (iz, iy) synthesizes [narray, ny, Z, Xp] at its global
          x-offset; the z transform is LOCAL (Z fully resident), the x
          transform borrows locality from z (one all_to_all pair over the
          flattened mesh); the result lands x-split -- exactly the
          per-process staging layout the multi-host fabric wants.
  pass 2: a z-slab [narray, Y, Bz, Xp] has Y fully resident, so the y
          transform is LOCAL; zero collectives for the single-host sink
          (one final all_to_all to whole-z-plane layout for multi-host
          parallel output).

This costs 2 all-to-alls for pass 1 + at most 1 for pass 2 per slab, all
transforms are local dense matmuls, and no GSPMD resharding is ever needed
(the naive spec -- y over "y", z over "z" -- forced XLA into involuntary
full rematerializations when landing into the x-split staging fabric).

The host buffer remains the y<->z transpose fabric; the mesh never holds
more than one slab.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import mmfft
from ..ops.modes import synthesize
from ..ops.modes_real import synthesize_pair
from ..utils.cache import BoundedCache
from .pencil_mmfft import _AX, _cfft_axis_pair, _cfft_last_pair, _flat_index

_CACHE = BoundedCache()


def _xspec(ndim: int) -> P:
    """x split over the flattened mesh, every other axis whole."""
    return P(*([None] * (ndim - 1)), _AX)


def _check_grid(ppd, mesh: Mesh):
    n = mesh.devices.size
    if ppd % n:
        raise ValueError(f"grid {ppd} not divisible by {n} mesh devices")


def _transform_x_pair(b, sign):
    """Pair transform along local-split x, borrowing locality from z.

    b: [2, A, ny, Z, Xp].  all_to_all gathers full x (paying with a z
    split over the flattened mesh), transforms locally, transposes back.
    """
    full = jax.lax.all_to_all(b, _AX, split_axis=b.ndim - 2,
                              concat_axis=b.ndim - 1, tiled=True)
    full = _cfft_last_pair(full, sign)
    return jax.lax.all_to_all(full, _AX, split_axis=b.ndim - 1,
                              concat_axis=b.ndim - 2, tiled=True)


def _transform_x_df64(rep, imp, sign):
    """df64 pair transform along local-split x (one all_to_all pair).

    rep, imp: (hi, lo) f32 pairs with component shape [.., Z, Xp].  The
    collectives move the 4 stacked f32 planes; transforms are the
    two-float int8 matmuls (mmfft._cfft_last_df64).
    """
    st = jnp.stack([rep[0], rep[1], imp[0], imp[1]])
    full = jax.lax.all_to_all(st, _AX, split_axis=st.ndim - 2,
                              concat_axis=st.ndim - 1, tiled=True)
    rep, imp = mmfft._cfft_last_df64(
        (full[0], full[1]), (full[2], full[3]), sign
    )
    st = jnp.stack([rep[0], rep[1], imp[0], imp[1]])
    st = jax.lax.all_to_all(st, _AX, split_axis=st.ndim - 1,
                            concat_axis=st.ndim - 2, tiled=True)
    return (st[0], st[1]), (st[2], st[3])


def _transform_x_complex(k, scaled):
    full = jax.lax.all_to_all(k, _AX, split_axis=k.ndim - 2,
                              concat_axis=k.ndim - 1, tiled=True)
    full = jnp.fft.ifft(full, axis=-1) * (full.shape[-1] if scaled else 1)
    return jax.lax.all_to_all(full, _AX, split_axis=k.ndim - 1,
                              concat_axis=k.ndim - 2, tiled=True)


def synth_ifft_zx_sharded(
    y0, ny, cfg, tables, dtype, mesh: Mesh, pair: bool,
    gen_phi: bool = False, phi_pair=None, df64: bool = False,
):
    """Pass-1 slab: x-split synthesis + inverse FFT over z (local) and x.

    Returns [narray, ny, Z, X] (pair: [narray, 2, ny, Z, X]) sharded
    x-split over the flattened mesh -- the staging-fabric layout.  ``y0``
    is traced: one compile per shape.

    ``phi_pair`` (the f_NL input pass) carries (same, reflected) phi(k)
    blocks elementwise-aligned with the slab's output indices -- host-
    precomputed reflections, so each device reads only its own columns:
    shape [ny, Z, X] per leaf, sharded x-split.
    """
    ppd = cfg.ppd
    _check_grid(ppd, mesh)
    if df64 and (gen_phi or phi_pair is not None):
        raise NotImplementedError("df64 excludes f_NL (pipeline fallback)")
    key = (
        "synth", cfg, ny, dtype, mesh, pair, gen_phi,
        phi_pair is not None, df64,
    )
    f = _CACHE.get(key)
    if f is None:
        nd = mesh.devices.size
        xp = ppd // nd

        def kernel(tables, y0, phi_blocks):
            ix = _flat_index()
            y = (y0 + jnp.arange(ny))[:, None, None]
            z = jnp.arange(ppd)[None, :, None]
            x = (ix * xp + jnp.arange(xp))[None, None, :]
            if df64:
                # the --dtype df64 parity mode: exact f32 synthesis +
                # two-float transforms, float64 staging values
                k = synthesize_pair(
                    y, z, x, cfg, tables, dtype=jnp.float32, accurate=True
                )
                b = jnp.swapaxes(k, 0, 1)  # (2, narray, ny, Z, Xp)
                zero = jnp.zeros_like(b[0])
                rep, imp = (b[0], zero), (b[1], zero)
                rep, imp = mmfft._cfft_axis_df64(rep, imp, -2, +1)  # z
                rep, imp = _transform_x_df64(rep, imp, +1)
                out = jnp.stack(
                    [mmfft._pair_to_f64(rep), mmfft._pair_to_f64(imp)]
                )
                return jnp.swapaxes(out, 0, 1)
            if pair:
                k = synthesize_pair(
                    y, z, x, cfg, tables, dtype=dtype, gen_phi=gen_phi,
                    phi_pair=phi_blocks,
                )
                b = jnp.swapaxes(k, 0, 1)  # (2, narray, ny, Z, Xp)
                b = _cfft_axis_pair(b, -2, +1)  # z local
                b = _transform_x_pair(b, +1)
                return jnp.swapaxes(b, 0, 1)
            k = synthesize(
                y, z, x, cfg, tables, dtype=dtype, gen_phi=gen_phi,
                phi_k=phi_blocks,
            )
            k = jnp.fft.ifft(k, axis=-2) * ppd  # z local
            return _transform_x_complex(k, scaled=True)

        gspec = _xspec(5 if pair else 4)
        tab_spec = jax.tree.map(lambda _: P(), tables)
        if phi_pair is None:
            f = jax.jit(
                shard_map(
                    partial(kernel, phi_blocks=None), mesh=mesh,
                    in_specs=(tab_spec, P()), out_specs=gspec,
                )
            )
        else:
            phi_spec = jax.tree.map(lambda _: _xspec(3), phi_pair)
            f = jax.jit(
                shard_map(
                    kernel, mesh=mesh,
                    in_specs=(tab_spec, P(), phi_spec), out_specs=gspec,
                )
            )
        _CACHE[key] = f
    if phi_pair is None:
        return f(tables, y0)
    return f(tables, y0, phi_pair)


def fwd_y_phi_nl_sharded(zslab, f_NL, inv_n3, mesh: Mesh, pair: bool):
    """phi z-slab: finish inverse FFT (y), apply non-linearity, forward y.

    zslab [1(, 2), Y, Bz, X] sharded x-split: Y is fully resident per
    device, so the whole round trip is collective-free.
    """
    _check_grid(zslab.shape[-1], mesh)
    key = ("phi_y", zslab.shape, zslab.dtype, mesh, pair)
    f = _CACHE.get(key)
    if f is None:
        if pair:

            def kernel(b, f_NL, inv_n3):
                b = jnp.swapaxes(b, 0, 1)  # (2, 1, Y, Bzl, Xp)
                # sign +1 == the FFTW unnormalized inverse: no 1/N, no xN
                b = _cfft_axis_pair(b, -3, +1)
                phi_x = (b[0] + f_NL * b[0] * b[0]) * inv_n3
                b = jnp.stack([phi_x, jnp.zeros_like(phi_x)])
                b = _cfft_axis_pair(b, -3, -1)
                return jnp.swapaxes(b, 0, 1)

        else:

            def kernel(b, f_NL, inv_n3):
                phi = jnp.fft.ifft(b, axis=-3) * b.shape[-3]
                phi_x = (phi.real + f_NL * phi.real * phi.real) * inv_n3
                return jnp.fft.fft(phi_x.astype(b.dtype), axis=-3)

        gspec = _xspec(zslab.ndim)
        f = jax.jit(
            shard_map(
                kernel, mesh=mesh, in_specs=(gspec, P(), P()),
                out_specs=gspec,
            )
        )
        _CACHE[key] = f
    return f(zslab, f_NL, inv_n3)


def fwd_zx_sharded(yslab, mesh: Mesh, pair: bool):
    """Forward FFT over z (local) and x of a phi y-slab [1(, 2), By, Z, X]."""
    _check_grid(yslab.shape[-1], mesh)
    key = ("phi_zx", yslab.shape, yslab.dtype, mesh, pair)
    f = _CACHE.get(key)
    if f is None:
        if pair:

            def kernel(b):
                b = jnp.swapaxes(b, 0, 1)
                b = _cfft_axis_pair(b, -2, -1)  # z local
                b = _transform_x_pair(b, -1)
                return jnp.swapaxes(b, 0, 1)

        else:

            def kernel(b):
                b = jnp.fft.fft(b, axis=-2)  # z local
                full = jax.lax.all_to_all(
                    b, _AX, split_axis=b.ndim - 2, concat_axis=b.ndim - 1,
                    tiled=True,
                )
                full = jnp.fft.fft(full, axis=-1)
                return jax.lax.all_to_all(
                    full, _AX, split_axis=b.ndim - 1,
                    concat_axis=b.ndim - 2, tiled=True,
                )

        gspec = _xspec(yslab.ndim)
        f = jax.jit(
            shard_map(kernel, mesh=mesh, in_specs=(gspec,), out_specs=gspec)
        )
        _CACHE[key] = f
    return f(yslab)


def ifft_y_sharded(
    zslab, mesh: Mesh, pair: bool, zplanes: bool = False, df64: bool = False
):
    """Pass-2 slab: inverse FFT over y of [narray(, 2), Y, Bz, X].

    Input is x-split, Y fully resident: the transform is local.  With
    ``zplanes`` the result is resharded (one all_to_all) so each device
    holds whole z-planes -- the multi-host parallel-output layout; the
    single-host sink materializes the x-split result directly.  ``df64``
    splits the float64 staging values into f32 pairs and transforms with
    the two-float int8 matmuls (the --dtype df64 parity mode).
    """
    _check_grid(zslab.shape[-1], mesh)
    if zplanes and zslab.shape[-2] % mesh.devices.size:
        raise ValueError(
            f"slab thickness {zslab.shape[-2]} not divisible by "
            f"{mesh.devices.size} devices for z-plane output"
        )
    key = ("iffty", zslab.shape, zslab.dtype, mesh, pair, zplanes, df64)
    f = _CACHE.get(key)
    if f is None:
        if df64:

            def kernel(b):
                p = jnp.swapaxes(b, 0, 1)  # (2, A, Y, Bzl, Xp) float64
                hi = p.astype(jnp.float32)
                lo = (p - hi.astype(jnp.float64)).astype(jnp.float32)
                rep, imp = (hi[0], lo[0]), (hi[1], lo[1])
                rep, imp = mmfft._cfft_axis_df64(rep, imp, -3, +1)
                b = jnp.stack(
                    [mmfft._pair_to_f64(rep), mmfft._pair_to_f64(imp)]
                )
                if zplanes:
                    b = jax.lax.all_to_all(
                        b, _AX, split_axis=b.ndim - 2,
                        concat_axis=b.ndim - 1, tiled=True,
                    )
                return jnp.swapaxes(b, 0, 1)

        elif pair:

            def kernel(b):
                b = jnp.swapaxes(b, 0, 1)  # (2, A, Y, Bz, Xp)
                b = _cfft_axis_pair(b, -3, +1)
                if zplanes:
                    b = jax.lax.all_to_all(
                        b, _AX, split_axis=b.ndim - 2,
                        concat_axis=b.ndim - 1, tiled=True,
                    )
                return jnp.swapaxes(b, 0, 1)

        else:

            def kernel(b):
                b = jnp.fft.ifft(b, axis=-3) * b.shape[-3]
                if zplanes:
                    b = jax.lax.all_to_all(
                        b, _AX, split_axis=b.ndim - 2,
                        concat_axis=b.ndim - 1, tiled=True,
                    )
                return b

        gspec = _xspec(zslab.ndim)
        if zplanes:
            spec = [None] * zslab.ndim
            spec[-2] = _AX
            out = P(*spec)
        else:
            out = gspec
        f = jax.jit(
            shard_map(kernel, mesh=mesh, in_specs=(gspec,), out_specs=out)
        )
        _CACHE[key] = f
    return f(zslab)
