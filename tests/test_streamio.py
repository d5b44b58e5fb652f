"""Overlapped output streaming: ordering, parity, error propagation."""

import numpy as np
import pytest

import jax.numpy as jnp

from zeldovich.utils.streamio import AsyncSlabWriter, stream_xspace


class RecordingWriter:
    def __init__(self, fail_at=None):
        self.calls = []
        self.closed = False
        self.fail_at = fail_at

    def write_slab(self, z, slab):
        if self.fail_at is not None and z == self.fail_at:
            raise RuntimeError(f"boom at {z}")
        self.calls.append((z, np.array(slab)))

    def close(self):
        self.closed = True


def test_stream_matches_serial_complex():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 8)) + 1j * rng.normal(size=(2, 8, 8, 8))
    w = RecordingWriter()
    stream_xspace(jnp.asarray(x), w, chunk=3)
    assert w.closed
    assert [z for z, _ in w.calls] == list(range(8))  # z-order preserved
    for z, slab in w.calls:
        np.testing.assert_allclose(slab, x[:, :, z, :])


def test_stream_matches_serial_pair():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 2, 8, 8, 8)).astype(np.float32)
    w = RecordingWriter()
    stream_xspace(jnp.asarray(x), w, pair=True, chunk=5)
    for z, slab in w.calls:
        np.testing.assert_allclose(
            slab, x[:, 0, :, z, :] + 1j * x[:, 1, :, z, :]
        )


def test_writer_error_propagates():
    x = jnp.zeros((1, 4, 4, 4), dtype=jnp.complex128)
    w = RecordingWriter(fail_at=2)
    with pytest.raises(RuntimeError, match="boom"):
        stream_xspace(x, w, chunk=1)


def test_async_writer_fifo():
    w = RecordingWriter()
    aw = AsyncSlabWriter(w, depth=2)
    for z in range(32):
        aw.submit(z, np.full((1, 2, 2), z))
    aw.close()
    assert [z for z, _ in w.calls] == list(range(32))
    assert w.closed


def test_writer_error_still_closes_writer():
    """A captured worker error must not leak the writer's file handles."""
    w = RecordingWriter(fail_at=1)
    aw = AsyncSlabWriter(w)
    with pytest.raises(RuntimeError, match="boom"):
        try:
            for z in range(4):
                aw.submit(z, np.zeros((2, 4, 4)))
        finally:
            aw.close()
    assert w.closed


def test_pwrite_full_survives_short_writes(monkeypatch, tmp_path):
    """_pwrite_full loops over short kernel writes (the 2 GiB pwrite cap)."""
    import os

    from zeldovich.utils import output as out_mod

    real_pwrite = os.pwrite
    CAP = 7  # force many short writes

    def capped(fd, data, offset):
        return real_pwrite(fd, bytes(data[:CAP]), offset)

    monkeypatch.setattr(out_mod.os, "pwrite", capped)
    fd = os.open(tmp_path / "f", os.O_CREAT | os.O_RDWR)
    payload = np.arange(100, dtype=np.uint8)
    out_mod._pwrite_full(fd, payload, 3)
    os.close(fd)
    got = (tmp_path / "f").read_bytes()
    assert got[3:103] == payload.tobytes()


def test_checkpoint_resave_wipes_stale_chunks(tmp_path):
    """meta.json is written last and a re-save removes stale chunks."""
    import jax.numpy as jnp

    from zeldovich.utils import checkpoint as ck

    big = jnp.arange(2 * 8 * 4 * 4, dtype=jnp.float32).reshape(2, 8, 4, 4)
    p = tmp_path / "ckpt"
    ck.save_kspace(big, p, target_bytes=256)  # several chunks
    stale = sorted(p.glob("k_*.npy"))
    assert len(stale) > 1
    # smaller re-save: every old chunk must be gone, not mixed in
    small = big[:, :4]
    ck.save_kspace(small, p, target_bytes=1 << 30)  # one chunk
    files = sorted(f.name for f in p.glob("k_*.npy"))
    assert files == ["k_00000.npy"]
    np.testing.assert_array_equal(ck.load_kspace(p), np.asarray(small))
