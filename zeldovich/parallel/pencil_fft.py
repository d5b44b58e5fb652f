"""Mesh-sharded 3-D FFT: pencil decomposition with all-to-alls.

The device-mesh replacement for the reference's out-of-core blocked FFT
(BlockArray, src/block_array.cpp): the NB^2 disk blocks become a
("z", "y") device mesh, StoreBlock/LoadBlock's y<->z transposes become
``lax.all_to_all`` collectives, and the "disk as shuffle fabric"
disappears -- the k-space state stays resident in device memory.

Dataflow per inverse transform of a [A, Y, Z, X] grid sharded
(replicated, "y", "z", local):

    local FFT over X
    all_to_all over "y":  [Yl, Zl, X] -> [Y, Zl, X/Py]   (y-pencils)
    local FFT over Y, all_to_all back
    all_to_all over "z":  [Yl, Zl, X] -> [Yl, Z, X/Pz]   (z-pencils)
    local FFT over Z, all_to_all back

The layout-preserving form (transpose back after each axis) costs 4
all-to-alls; a fused 2-transpose variant that leaves the result in pencil
layout is provided for pipelines that can consume it directly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def _ifft_scaled(a, axis):
    return jnp.fft.ifft(a, axis=axis) * a.shape[axis]


def _fft(a, axis):
    return jnp.fft.fft(a, axis=axis)


def _transform_axis_sharded(block, axis_name, axis, transform):
    """FFT along a sharded array axis by borrowing locality from X.

    block: local [..., Y_l, Z_l, X]; ``axis`` is the (negative) array axis
    to transform (-3 for Y sharded over "y", -2 for Z over "z").
    """
    # gather the full axis, paying with an X split
    full = jax.lax.all_to_all(block, axis_name, split_axis=block.ndim - 1,
                              concat_axis=block.ndim + axis, tiled=True)
    full = transform(full, axis)
    # restore the original layout
    return jax.lax.all_to_all(full, axis_name, split_axis=block.ndim + axis,
                              concat_axis=block.ndim - 1, tiled=True)


def _pencil_3d(block, transform):
    """Layout-preserving 3-D transform of a local [..., Y_l, Z_l, X] block."""
    block = transform(block, -1)  # X is local
    block = _transform_axis_sharded(block, "y", -3, transform)
    block = _transform_axis_sharded(block, "z", -2, transform)
    return block


def _check_divisible(shape, mesh: Mesh, final: bool = False):
    """Validate grid/mesh divisibility with a clear error.

    The layout-preserving transforms need X divisible by each mesh axis;
    the transpose-light ``final`` forms leave the result x-pencil-sharded
    over BOTH axes and additionally need X % (py * pz) == 0.
    """
    py, pz = mesh.shape["y"], mesh.shape["z"]
    Y, Z, X = shape[-3], shape[-2], shape[-1]
    if Y % py or Z % pz or X % py or X % pz:
        raise ValueError(
            f"grid {shape[-3:]} not divisible by mesh (y={py}, z={pz})"
        )
    if final and X % (py * pz):
        raise ValueError(
            f"x extent {X} not divisible by {py * pz} devices (the final "
            "pencil layout splits x over the whole mesh)"
        )


def _pencil_3d_final(block, transform):
    """Transpose-light 3-D transform: 2 all-to-alls, output left in pencil
    layout (X sharded over ("y", "z"), Y and Z unsharded locally).

    The layout-preserving form costs 4 all-to-alls; when the consumer only
    needs the *global logical* array (e.g. host gather for particle
    output), declaring the pencil layout in out_specs halves the traffic.
    """
    nd = block.ndim
    block = transform(block, -1)  # X local
    # gather Y (pay with an X split over "y"): [.., Y, Zl, X/Py]
    b = jax.lax.all_to_all(block, "y", split_axis=nd - 1, concat_axis=nd - 3,
                           tiled=True)
    b = transform(b, -3)
    # gather Z (pay with an X split over "z"): [.., Y, Z, X/(Py*Pz)]
    b = jax.lax.all_to_all(b, "z", split_axis=nd - 1, concat_axis=nd - 2,
                           tiled=True)
    return transform(b, -2)


def _final_specs(ndim):
    head = (None,) * (ndim - 3)
    return (
        P(*head, "y", "z", None),            # input: (y, z) block layout
        P(*head, None, None, ("y", "z")),    # output: x-pencil layout
    )


def ifft3_sharded_final(garr, mesh: Mesh):
    """Unnormalized inverse 3-D FFT leaving the result in pencil layout.

    Same logical result as ifft3_sharded (the global array is identical);
    only the output sharding differs: (..., None, None, ("y","z")).
    """
    _check_divisible(garr.shape, mesh, final=True)
    in_spec, out_spec = _final_specs(garr.ndim)
    f = shard_map(
        partial(_pencil_3d_final, transform=_ifft_scaled),
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=out_spec,
    )
    return f(garr)


def ifft3_sharded(garr, mesh: Mesh):
    """Unnormalized (FFTW +1) inverse 3-D FFT of a mesh-sharded grid.

    garr: [..., Y, Z, X] sharded (..., "y", "z", None) on ``mesh``.
    Returns the same layout, fully transformed.
    """
    _check_divisible(garr.shape, mesh)
    nbatch = garr.ndim - 3
    spec = P(*(None,) * nbatch, "y", "z", None)
    f = shard_map(
        partial(_pencil_3d, transform=_ifft_scaled),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
    )
    return f(garr)


def fft3_sharded(garr, mesh: Mesh):
    """Forward (FFTW -1, unnormalized) 3-D FFT, same sharding contract."""
    _check_divisible(garr.shape, mesh)
    nbatch = garr.ndim - 3
    spec = P(*(None,) * nbatch, "y", "z", None)
    f = shard_map(
        partial(_pencil_3d, transform=_fft),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
    )
    return f(garr)
