"""Particle output: Abacus-compatible binary formats, density file, stats.

Byte layouts are identical to the reference's C++ structs including
alignment padding (include/output.h:19-42; sizes/offsets verified against a
compiled oracle): RVZel (32 B, displ@8, vel@20), RVdoubleZel (56 B,
displ@8, vel@32), Zeldovich (32 B, displ@8), ZelSimple (12 B).

Decoding follows src/output.cpp:41-234: displacements come from the packed
inverse-FFT'd complex planes (pos = [Im A, Re B, Im B]), velocities from
the PLT velocity arrays or ``vnorm * displ`` with the f_cluster growth
factor; records store (i,j,k) = (z,y,x) lattice coords and displ/vel in
(z,y,x) component order; slab z appends to ``ic_{z*CPD/PPD}``.

The per-slab decode is vectorized numpy on host (the device hands back one
z-slab at a time), with the same global stats: sum of squared pixel density
and component-wise signed max displacement.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass

import numpy as np

from .params import Parameters


def _pwrite_full(fd: int, data, offset: int):
    """pwrite that survives short writes.

    Linux caps one pwrite at ~2 GiB (0x7ffff000); an 8192^2 RVZel slab is
    2 GiB exactly, so an unchecked single call would silently truncate at
    the reference's design scale.  Accepts any contiguous buffer.
    """
    view = memoryview(data).cast("B")
    done = 0
    while done < len(view):
        n = os.pwrite(fd, view[done:], offset + done)
        if n <= 0:  # pragma: no cover - kernel error path
            raise OSError(f"pwrite returned {n} at offset {offset + done}")
        done += n


class _SparseFile:
    """Pre-sized file written by pwrite at computed offsets (parallel IO)."""

    def __init__(self, path, size: int):
        self.fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
        # exact size: a stale larger file from a previous run must not
        # keep trailing garbage past this run's data
        if os.fstat(self.fd).st_size != size:
            os.ftruncate(self.fd, size)

    def pwrite(self, data, offset: int):
        _pwrite_full(self.fd, data, offset)

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

_RVZEL = np.dtype(
    {
        "names": ["i", "j", "k", "displ", "vel"],
        "formats": ["<u2", "<u2", "<u2", "<3f4", "<3f4"],
        "offsets": [0, 2, 4, 8, 20],
        "itemsize": 32,
    }
)

_RVDOUBLEZEL = np.dtype(
    {
        "names": ["i", "j", "k", "displ", "vel"],
        "formats": ["<u2", "<u2", "<u2", "<3f8", "<3f8"],
        "offsets": [0, 2, 4, 8, 32],
        "itemsize": 56,
    }
)

_ZEL = np.dtype(
    {
        "names": ["i", "j", "k", "displ"],
        "formats": ["<u2", "<u2", "<u2", "<3f8"],
        "offsets": [0, 2, 4, 8],
        "itemsize": 32,
    }
)

_ZELSIMPLE = np.dtype({"names": ["displ"], "formats": ["<3f4"], "offsets": [0], "itemsize": 12})

OUTPUT_DTYPES = {
    "RVZel": _RVZEL,
    "RVdoubleZel": _RVDOUBLEZEL,
    "Zeldovich": _ZEL,
    "ZelSimple": _ZELSIMPLE,
}


def output_dtype(icformat: str) -> np.dtype:
    try:
        return OUTPUT_DTYPES[icformat]
    except KeyError:
        raise ValueError(f'unknown ICFormat "{icformat}"') from None


def setup_output_dir(param: Parameters):
    """Remove stale ic_* / zeldovich.* files; create the directory."""
    out = param.output_path
    if out.exists():
        for entry in out.iterdir():
            if entry.is_file() and (
                entry.name.startswith("ic_") or entry.name.startswith("zeldovich.")
            ):
                entry.unlink()
    out.mkdir(parents=True, exist_ok=True)


@dataclass
class OutputWriter:
    """Streams decoded z-slabs into ic_* files; accumulates global stats.

    Uses the native threaded pack/IO runtime (zeldovich.native) when
    available, with a transparent numpy fallback.
    """

    param: Parameters
    bytes_written: int = 0
    use_native: bool = True
    _densfp: object = None
    write_seconds: float = 0.0
    parallel: bool = False  # multi-process: pwrite at slab offsets

    def __post_init__(self):
        p = self.param
        self.just_density = p.qdensity == 2
        # {sum dens^2, signed max_disp x, y, z}
        self._stats = np.zeros(4)
        self._native_buf = None
        self._pfds: dict = {}
        if not self.just_density:
            self.dtype = output_dtype(p.ICFormat)
            if self.use_native:
                from .. import native

                if native.load() is not None:
                    self._native_buf = np.zeros(
                        p.ppd * p.ppd * self.dtype.itemsize, dtype=np.uint8
                    )
        if p.qdensity:
            name = str(p.density_filename).replace("{:d}", "{}").format(p.ppd)
            path = p.output_path / name
            if self.parallel:
                nslab = 1 if p.qoneslab >= 0 else p.ppd
                self._densfp = _SparseFile(path, nslab * p.ppd * p.ppd * 4)
            else:
                self._densfp = open(path, "wb")

    # -- parallel (multi-process) slab placement ------------------------
    # The reference appends slabs in ascending z to ic_{z*CPD/PPD}
    # (output.cpp:208-212).  Slab sizes are fixed, so in parallel mode any
    # process can pwrite its slab at a computed offset; files are
    # pre-sized (idempotently, every process computes the same size) so
    # the byte image is identical to the serial append.
    def _slab_index(self, z: int) -> tuple[int, int, int]:
        """(file_number, slab_index_within_file, slabs_in_file) for z."""
        p = self.param
        if p.qoneslab >= 0:
            return z * p.cpd // p.ppd, 0, 1
        n = z * p.cpd // p.ppd
        zmin = -((-n * p.ppd) // p.cpd)  # ceil(n*ppd/cpd)
        znext = -((-(n + 1) * p.ppd) // p.cpd)
        return n, z - zmin, min(znext, p.ppd) - zmin

    def _pfd(self, n: int, nslab: int) -> int:
        fd = self._pfds.get(n)
        if fd is None:
            fn = self.param.output_path / f"ic_{n}"
            fd = os.open(fn, os.O_CREAT | os.O_WRONLY, 0o644)
            size = nslab * self.param.ppd**2 * self.dtype.itemsize
            if os.fstat(fd).st_size != size:  # exact: no stale tails
                os.ftruncate(fd, size)
            self._pfds[n] = fd
        return fd

    @property
    def density_variance(self) -> float:
        return float(self._stats[0])

    @property
    def max_disp(self) -> np.ndarray:
        return self._stats[1:4]

    # ------------------------------------------------------------------
    def decode_slab(self, z: int, slabs: np.ndarray):
        """Decode one z-slab.

        slabs: (narray, ppd, ppd) complex, [a][y][x] after the full inverse
        FFT.  Returns (records or None, density or None).
        """
        p = self.param
        ppd = p.ppd
        A = slabs[0]
        dens = A.real  # densitynorm = 1

        if self.just_density:
            return None, dens

        B = slabs[1]
        pos = np.empty((3, ppd, ppd))
        pos[0] = A.imag
        pos[1] = B.real
        pos[2] = B.imag

        if p.qPLT:
            V1, V2 = slabs[2], slabs[3]
            vel = np.empty((3, ppd, ppd))
            vel[0] = V1.imag
            vel[1] = V2.real
            vel[2] = V2.imag
        else:
            vel = pos * self._vnorm

        rec = np.zeros((ppd, ppd), dtype=self.dtype)
        names = self.dtype.names
        if "i" in names:
            rec["i"] = z
            rec["j"] = np.arange(ppd, dtype=np.uint16)[:, None]
            rec["k"] = np.arange(ppd, dtype=np.uint16)[None, :]
        # (z, y, x) component order (output.cpp:133-138)
        rec["displ"][..., 0] = pos[2]
        rec["displ"][..., 1] = pos[1]
        rec["displ"][..., 2] = pos[0]
        if "vel" in names:
            rec["vel"][..., 0] = vel[2]
            rec["vel"][..., 1] = vel[1]
            rec["vel"][..., 2] = vel[0]

        # global stats: signed component-wise max displacement
        for j in range(3):
            flat = pos[j].ravel()
            idx = np.argmax(np.abs(flat))
            if abs(flat[idx]) > abs(self._stats[1 + j]):
                self._stats[1 + j] = flat[idx]
        return rec, dens

    @property
    def _vnorm(self) -> float:
        # f_cluster growth factor applied at output when not PLT
        # (output.cpp:78-82)
        return (math.sqrt(1.0 + 24 * self.param.f_cluster) - 1) * 0.25

    def write_slab(self, z: int, slabs: np.ndarray):
        """Decode + append one z-slab to its ic_ file (and density file)."""
        import time as _time

        p = self.param
        if p.qoneslab >= 0 and z != p.qoneslab:
            return
        _t0 = _time.perf_counter()
        try:
            self._write_slab(z, slabs)
        finally:
            self.write_seconds += _time.perf_counter() - _t0

    def _write_slab(self, z: int, slabs: np.ndarray):
        p = self.param
        if self._native_buf is not None:
            from .. import native

            slabs = np.ascontiguousarray(slabs, dtype=np.complex128)
            if native.pack_slab(
                p.ICFormat,
                z,
                slabs,
                bool(p.qPLT),
                self._vnorm,
                self._native_buf,
                self._stats,
            ):
                self._emit_records(z, self._native_buf)
                if p.qdensity:
                    dens = np.ascontiguousarray(slabs[0]).real
                    self._emit_density(z, dens)
                return
        rec, dens = self.decode_slab(z, slabs)
        self._stats[0] += float(np.sum(dens * dens))
        if rec is not None:
            self._emit_records(z, rec)
        if p.qdensity:
            self._emit_density(z, dens)

    def _emit_records(self, z: int, buf: np.ndarray):
        p = self.param
        if self.parallel:
            n, idx, nslab = self._slab_index(z)
            _pwrite_full(
                self._pfd(n, nslab),
                np.ascontiguousarray(buf),
                idx * p.ppd**2 * self.dtype.itemsize,
            )
        else:
            fn = p.output_path / f"ic_{z * p.cpd // p.ppd}"
            if buf is self._native_buf:
                from .. import native

                if not native.append(
                    fn, buf, direct=bool(p.AllowDirectIO)
                ):  # pragma: no cover - IO failure path
                    with open(fn, "ab") as fp:
                        buf.tofile(fp)
            else:
                with open(fn, "ab") as fp:
                    buf.tofile(fp)
        self.bytes_written += buf.nbytes

    def _emit_density(self, z: int, dens: np.ndarray):
        p = self.param
        data = np.ascontiguousarray(dens, dtype=np.float32)
        if self.parallel:
            zi = 0 if p.qoneslab >= 0 else z
            self._densfp.pwrite(data, zi * p.ppd * p.ppd * 4)
        else:
            data.tofile(self._densfp)
        self.bytes_written += data.size * 4

    def close(self):
        if self._densfp is not None:
            self._densfp.close()
            self._densfp = None
        for fd in self._pfds.values():
            os.close(fd)
        self._pfds.clear()
        if self.write_seconds > 0:
            # bandwidth report in the reference's style (output.cpp:319-325)
            print(
                f"WriteParticlesSlab took {self.write_seconds:.3g} sec to "
                f"write {self.bytes_written / 1e6:.3g} MB ==> "
                f"{self.bytes_written / 1e6 / self.write_seconds:.3g} MB/sec",
                file=sys.stderr,
            )

    # -- cross-process stats contract -----------------------------------
    def stats_vector(self) -> np.ndarray:
        """This process's mergeable stats: [sum dens^2, signed max_disp
        x/y/z, bytes_written] -- the reduction payload for multi-host runs
        (parallel/multihost.reduce_stats)."""
        return np.concatenate([self._stats, [float(self.bytes_written)]])

    def merge_stats(self, allstats: np.ndarray):
        """Replace local stats with the global combination.

        allstats: (nproc, 5) stack of every process's stats_vector().
        Density variance and byte counts sum; max displacement keeps the
        largest-magnitude signed value per component.
        """
        self._stats[0] = allstats[:, 0].sum()
        for j in range(1, 4):
            col = allstats[:, j]
            self._stats[j] = col[np.argmax(np.abs(col))]
        self.bytes_written = int(allstats[:, 4].sum())

    # ------------------------------------------------------------------
    def report(self, Pk) -> dict:
        """Final statistics, printed like the reference (zeldovich.cpp:987-1011)."""
        p = self.param
        rms = math.sqrt(self.density_variance / p.ppd**3)
        pred = Pk.sigmaR(p.separation / 4.0) * p.boxsize**1.5
        out = {
            "rms_density": rms,
            "rms_density_prediction": pred,
            "max_disp": tuple(self.max_disp),
        }
        print(f"The rms density variation of the pixels is {rms:f}", file=sys.stderr)
        print(
            f"This could be compared to the P(k) prediction of {pred:f}",
            file=sys.stderr,
        )
        if not self.just_density:
            packer = "native" if self._native_buf is not None else "numpy"
            print(f"Particle packer: {packer}", file=sys.stderr)
            print(
                "The maximum component-wise displacements are "
                f"({self.max_disp[0]:g}, {self.max_disp[1]:g}, {self.max_disp[2]:g}), "
                "same units as BoxSize.",
                file=sys.stderr,
            )
            if self.max_disp[2] != 0:
                out["max_cpd"] = int(p.boxsize / (2 * abs(self.max_disp[2])))
                print(
                    "For Abacus' 2LPT implementation to work (assuming "
                    "FINISH_WAIT_RADIUS = 1),\n\tthis implies a maximum CPD of "
                    f"{out['max_cpd']}",
                    file=sys.stderr,
                )
        return out


def read_particles(path, icformat: str) -> np.ndarray:
    """Read an ic_* file back into a structured array (for tests/tools)."""
    return np.fromfile(path, dtype=output_dtype(icformat))
