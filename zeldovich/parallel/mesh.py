"""Device-mesh construction for the sharded pipeline.

The grid [narray, y, z, x] is sharded over a 2-D ("z", "y") device mesh:
the reference's NB x NB block decomposition (block_array.h:32-114) maps
onto mesh axes, device memory replaces the disk, and the y<->z block
transposes become all-to-alls inside the pencil FFT.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, mesh_shape=None) -> Mesh:
    """A ("z", "y") mesh over the given (or all) devices.

    mesh_shape: optional (nz, ny); default factors the device count as
    close to square as possible (nz >= ny), which keeps each axis's
    all-to-all group small; the devices are joined all to all, so the
    shape follows the algorithm alone.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_shape is None:
        ny = int(math.sqrt(n))
        while n % ny:
            ny -= 1
        mesh_shape = (n // ny, ny)
    nz, ny = mesh_shape
    if nz * ny != n:
        raise ValueError(f"mesh shape {mesh_shape} != {n} devices")
    arr = np.asarray(devices).reshape(nz, ny)
    return Mesh(arr, axis_names=("z", "y"))


def grid_sharding(mesh: Mesh, batch_axes: int = 1) -> NamedSharding:
    """Sharding for a [..., y, z, x] grid: y over "y", z over "z", x local."""
    spec = P(*(None,) * batch_axes, "y", "z", None)
    return NamedSharding(mesh, spec)
