"""Sharded (per-device shard dump) checkpoints + compiled-program caches."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zeldovich.parallel.mesh import make_mesh
from zeldovich.utils.cache import BoundedCache
from zeldovich.utils.checkpoint import load_sharded, save_sharded

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def test_save_load_sharded_roundtrip(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(mesh_shape=(4, 2))
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 16, 16, 16))
    spec = P(None, "y", "z", None)
    ga = jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
    save_sharded(ga, tmp_path / "ck")
    assert (tmp_path / "ck" / "meta.json").exists()
    assert len(list((tmp_path / "ck").glob("shard_d*.npy"))) == 8
    back = load_sharded(tmp_path / "ck", mesh)
    assert back.sharding.spec == spec
    np.testing.assert_array_equal(np.asarray(back), a)


def test_load_sharded_rejects_changed_mesh(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(mesh_shape=(4, 2))
    ga = jax.device_put(
        jnp.zeros((2, 16, 16, 16)),
        NamedSharding(mesh, P(None, "y", "z", None)),
    )
    save_sharded(ga, tmp_path / "ck")
    other = make_mesh(mesh_shape=(2, 4))
    with pytest.raises(ValueError, match="mesh mismatch"):
        load_sharded(tmp_path / "ck", other)


def test_save_sharded_wipes_stale_chunks(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(mesh_shape=(4, 2))
    sh = NamedSharding(mesh, P(None, "y", "z", None))
    ga = jax.device_put(jnp.ones((2, 16, 16, 16)), sh)
    save_sharded(ga, tmp_path / "ck")
    stale = tmp_path / "ck" / "shard_d999.npy"  # no such device
    stale.write_bytes(b"junk")
    save_sharded(ga, tmp_path / "ck")  # re-save must not mix old chunks
    assert not stale.exists()


def test_bounded_cache_evicts_lru():
    c = BoundedCache(maxsize=3)
    for i in range(3):
        c[i] = f"v{i}"
    assert c.get(0) == "v0"  # touch 0: now 1 is LRU
    c[3] = "v3"
    assert len(c) == 3
    assert c.get(1) is None  # evicted
    assert c.get(0) == "v0" and c.get(3) == "v3"
