"""Mesh-sharded complex-free pencil FFT (real pairs + matmul DFTs).

The pair-representation twin of parallel/pencil_fft.py: identical
all_to_all pencil transposes over the ("z", "y") mesh, with each local
1-D transform done as dense/four-step matmuls (ops/mmfft) instead of
a complex FFT -- no complex dtypes anywhere in the compiled program.

Layout contract: pair grids are (2, A, Y, Z, X) sharded
(None, None, "y", "z", None).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import mmfft


def _cfft_last_pair(block, sign):
    re, im = mmfft.cfft_last(block[0], block[1], sign)
    return jnp.stack([re, im])


def _cfft_axis_pair(block, axis, sign):
    """In-place axis contraction (mmfft.cfft_axis): no moveaxis copies,
    and the same FP expression as the in-core path -- cross-mode byte
    equality requires every mode to transform with the identical form."""
    re, im = mmfft.cfft_axis(block[0], block[1], axis, sign)
    return jnp.stack([re, im])


def _transform_axis_pair(block, axis_name, axis, sign):
    """Pair transform along a sharded axis, borrowing locality from X.

    Layout-preserving: all_to_all gathers the full axis (paying with an X
    split over ``axis_name``), transforms it locally, and transposes back.
    """
    full = jax.lax.all_to_all(
        block, axis_name, split_axis=block.ndim - 1,
        concat_axis=block.ndim + axis, tiled=True,
    )
    full = _cfft_axis_pair(full, axis, sign)
    return jax.lax.all_to_all(
        full, axis_name, split_axis=block.ndim + axis,
        concat_axis=block.ndim - 1, tiled=True,
    )


def _pencil_3d_pair(block, sign):
    """Local [2, A, Yl, Zl, X] block: 3-D transform with 4 all-to-alls."""
    block = _cfft_last_pair(block, sign)  # X local
    block = _transform_axis_pair(block, "y", -3, sign)
    return _transform_axis_pair(block, "z", -2, sign)


from .pencil_fft import _check_divisible as _check  # shared validation


def _spec(ndim):
    return P(*(None,) * (ndim - 3), "y", "z", None)


def _pencil_3d_final_pair(block, sign):
    """Transpose-light pair transform (2 all-to-alls; see pencil_fft)."""
    nd = block.ndim
    block = _cfft_last_pair(block, sign)
    b = jax.lax.all_to_all(block, "y", split_axis=nd - 1, concat_axis=nd - 3,
                           tiled=True)
    b = _cfft_axis_pair(b, -3, sign)
    b = jax.lax.all_to_all(b, "z", split_axis=nd - 1, concat_axis=nd - 2,
                           tiled=True)
    return _cfft_axis_pair(b, -2, sign)


def ifft3_pair_sharded_final(gpair, mesh: Mesh):
    """Inverse pair FFT leaving the result in x-pencil layout."""
    _check(gpair.shape, mesh, final=True)
    head = (None,) * (gpair.ndim - 3)
    f = shard_map(
        partial(_pencil_3d_final_pair, sign=+1),
        mesh=mesh,
        in_specs=(P(*head, "y", "z", None),),
        out_specs=P(*head, None, None, ("y", "z")),
    )
    return f(gpair)


def ifft3_pair_sharded(gpair, mesh: Mesh):
    """Unnormalized inverse (FFTW +1) of a sharded pair grid."""
    _check(gpair.shape, mesh)
    f = shard_map(
        partial(_pencil_3d_pair, sign=+1),
        mesh=mesh,
        in_specs=(_spec(gpair.ndim),),
        out_specs=_spec(gpair.ndim),
    )
    return f(gpair)


def fft3_pair_sharded(gpair, mesh: Mesh):
    """Forward (FFTW -1), unnormalized."""
    _check(gpair.shape, mesh)
    f = shard_map(
        partial(_pencil_3d_pair, sign=-1),
        mesh=mesh,
        in_specs=(_spec(gpair.ndim),),
        out_specs=_spec(gpair.ndim),
    )
    return f(gpair)


# -- fused sharded half-spectrum forward ------------------------------------

_AX = ("z", "y")  # flattened mesh: device (iz, iy) -> x-block iz*py + iy


def _flat_index():
    """This device's slot in the flattened ("z", "y") mesh (the _AX order)."""
    py = jax.lax.axis_size("y")
    return jax.lax.axis_index("z") * py + jax.lax.axis_index("y")


from ..utils.cache import BoundedCache

_HALF_CACHE = BoundedCache()


def xspace_half_pair_sharded(
    cfg, tables, pk_src, mesh: Mesh, dtype, zplanes: bool = False
):
    """Fused sharded half-spectrum forward: 2 all-to-alls total.

    Each device synthesizes its own x-columns of the FULL half-spectrum
    box (ky in [0, half], all Z) -- synthesis is a pure function of the
    global index -- so the z transform and the c2r y transform are fully
    local and only the x transform exchanges data (one all_to_all pair
    borrowing locality from z).  Compare the full-grid pencil path: ~2.2x
    the FFT flops plus mirror assembly, at the same 2 collectives.

    pk_src: the source-resolved amplitude field (h+1, Z, X)
    (modes_real.pk_effective_half_src), sharded x-split at dispatch.
    Returns (narray, 2, Y, Z, X) sharded x-split, or with whole z-planes
    per device when ``zplanes`` (the multi-host parallel-output layout).
    """
    from ..ops.modes_real import synthesize_half_pair_at

    ppd = cfg.ppd
    nd = mesh.devices.size
    if ppd % nd:
        raise ValueError(f"grid {ppd} not divisible by {nd} mesh devices")
    key = (cfg, dtype, mesh, zplanes)
    f = _HALF_CACHE.get(key)
    if f is None:
        half = ppd // 2
        xp = ppd // nd

        def kernel(tables, pk):
            ix = _flat_index()
            y = jnp.arange(half + 1)[:, None, None]
            z = jnp.arange(ppd)[None, :, None]
            x = (ix * xp + jnp.arange(xp))[None, None, :]
            spm = synthesize_half_pair_at(
                y, z, x, cfg, tables, dtype=dtype, pk_eff=pk
            )
            re, im = spm[..., 0, :, :, :], spm[..., 1, :, :, :]
            re, im = mmfft.cfft_axis(re, im, -2, +1)  # z local
            st = jnp.stack([re, im])
            full = jax.lax.all_to_all(
                st, _AX, split_axis=st.ndim - 2, concat_axis=st.ndim - 1,
                tiled=True,
            )
            fr, fi = mmfft.cfft_last(full[0], full[1], +1)  # x local
            st = jax.lax.all_to_all(
                jnp.stack([fr, fi]), _AX, split_axis=st.ndim - 1,
                concat_axis=st.ndim - 2, tiled=True,
            )
            spm2 = jnp.stack([st[0], st[1]], axis=-4)
            out = mmfft.c2r_y_pair(spm2)  # y local: rows fully resident
            if zplanes:
                out = jax.lax.all_to_all(
                    out, _AX, split_axis=out.ndim - 2,
                    concat_axis=out.ndim - 1, tiled=True,
                )
            return out

        tab_spec = jax.tree.map(lambda _: P(), tables)
        pk_spec = P(None, None, _AX)
        if zplanes:
            ospec = P(None, None, None, _AX, None)
        else:
            ospec = P(None, None, None, None, _AX)
        f = jax.jit(
            shard_map(
                kernel, mesh=mesh, in_specs=(tab_spec, pk_spec),
                out_specs=ospec,
            )
        )
        _HALF_CACHE[key] = f
    return f(tables, pk_src)


# -- fused sharded half-spectrum forward, df64 parity mode ------------------


def xspace_half_df64_sharded(
    cfg, tables, pk_src, mesh: Mesh, zplanes: bool = False
):
    """The --dtype df64 parity mode on a device mesh: 2 all-to-alls total.

    Same dataflow as xspace_half_pair_sharded -- each device synthesizes
    its own x-columns of the full half-spectrum box, the z and c2r-y
    transforms are local, only the x transform exchanges data -- with the
    exact-primitive f32 draw chain (ops/accurate.py) and two-float int8
    transforms (ozaki.omatmul_pair).  Every collective moves f32 planes
    (the 4 pair components); the single f64 op is the output conversion.

    pk_src: float32 source-resolved amplitude field (h+1, Z, X)
    (modes_real.pk_effective_half_src), x-split at dispatch.  Returns
    (narray, 2, Y, Z, X) float64 sharded x-split, or whole z-planes per
    device when ``zplanes`` (the multi-host parallel-output layout).
    """
    from ..ops.modes_real import synthesize_half_pair_at

    ppd = cfg.ppd
    nd = mesh.devices.size
    if ppd % nd:
        raise ValueError(f"grid {ppd} not divisible by {nd} mesh devices")
    key = (cfg, "df64", mesh, zplanes)
    f = _HALF_CACHE.get(key)
    if f is None:
        half = ppd // 2
        xp = ppd // nd

        def kernel(tables, pk):
            ix = _flat_index()
            y = jnp.arange(half + 1)[:, None, None]
            z = jnp.arange(ppd)[None, :, None]
            x = (ix * xp + jnp.arange(xp))[None, None, :]
            spm = synthesize_half_pair_at(
                y, z, x, cfg, tables, dtype=jnp.float32, pk_eff=pk,
                accurate=True,
            )  # (narray, 2pm, 2reim, h+1, Z, Xp), exact f32
            zero = jnp.zeros_like(spm[..., 0, :, :, :])
            rep = (spm[..., 0, :, :, :], zero)
            imp = (spm[..., 1, :, :, :], zero)
            rep, imp = mmfft._cfft_axis_df64(rep, imp, -2, +1)  # z local
            st = jnp.stack([rep[0], rep[1], imp[0], imp[1]])
            full = jax.lax.all_to_all(
                st, _AX, split_axis=st.ndim - 2, concat_axis=st.ndim - 1,
                tiled=True,
            )
            rep, imp = (full[0], full[1]), (full[2], full[3])
            rep, imp = mmfft._cfft_last_df64(rep, imp, +1)  # x local
            st = jnp.stack([rep[0], rep[1], imp[0], imp[1]])
            st = jax.lax.all_to_all(
                st, _AX, split_axis=st.ndim - 1, concat_axis=st.ndim - 2,
                tiled=True,
            )
            rep, imp = (st[0], st[1]), (st[2], st[3])
            # y local: rows fully resident
            out_re, out_im = mmfft._c2r_y_df64(rep, imp)
            out = jnp.stack([out_re[0], out_re[1], out_im[0], out_im[1]])
            if zplanes:
                out = jax.lax.all_to_all(
                    out, _AX, split_axis=out.ndim - 2,
                    concat_axis=out.ndim - 1, tiled=True,
                )
            return jnp.stack(
                [
                    mmfft._pair_to_f64((out[0], out[1])),
                    mmfft._pair_to_f64((out[2], out[3])),
                ],
                axis=1,
            )

        tab_spec = jax.tree.map(lambda _: P(), tables)
        pk_spec = P(None, None, _AX)
        if zplanes:
            ospec = P(None, None, None, _AX, None)
        else:
            ospec = P(None, None, None, None, _AX)
        f = jax.jit(
            shard_map(
                kernel, mesh=mesh, in_specs=(tab_spec, pk_spec),
                out_specs=ospec,
            )
        )
        _HALF_CACHE[key] = f
    return f(tables, pk_src)
