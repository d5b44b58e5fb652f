"""The end-to-end IC generation pipeline (single-host orchestration).

Phases mirror the reference driver (src/zeldovich.cpp:848-1032) but the
dataflow is whole-grid on the device:

1. [f_NL only] phi pass: synthesize phi(k) -> inverse FFT -> apply local
   non-Gaussianity in configuration space -> forward FFT
   (ZeldovichZ(gen_phi) + ZeldovichXY_Phi, zeldovich.cpp:699-790).
2. Mode synthesis of the packed displacement/velocity arrays (ZeldovichZ).
3. Unnormalized inverse 3-D FFT (the z-pass + BlockArray transpose +
   xy-pass collapse into one sharded FFT; no disk, no y-shift bookkeeping).
4. Per-z-slab decode + serialization (ZeldovichXY's WriteParticlesSlab).

The k-space state between phases 2 and 3 is the PART1/PART2 checkpoint
boundary (the reference's on-disk BlockArray, zeldovich.cpp:835-846).
"""

from __future__ import annotations

import sys
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import fft, plt as plt_ops
from ..ops.modes import SynthConfig, SynthTables
from ..ops.modes_fast import synthesize_full_fast
from ..utils.output import OutputWriter, setup_output_dir
from ..utils.params import Parameters
from ..utils.power import PowerSpectrum, mode_amplitude_tables


class Zeldovich:
    """Flagship model: parameters -> displacement/velocity fields."""

    def __init__(self, param: Parameters, dtype=jnp.float64):
        self.param = param
        self.dtype = dtype
        self.cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        self.Pk = PowerSpectrum(param)
        pk_n2, M_n2 = mode_amplitude_tables(self.Pk, param)
        self.cfg = SynthConfig.from_params(param, self.Pk.fixed_power)
        eig = None
        if param.qPLT:
            print("Using PLT eigenmodes.", file=sys.stderr)
            eig = plt_ops.load_eigmodes(param.resolve_path(param.PLT_filename))
        self.tables = SynthTables.build(
            param.seed, param.ppd, pk_n2, M_n2=M_n2, eig=eig
        )
        self._D_source = None
        if param.version == 1:
            # legacy MT19937 stream, generated host-side (ops/v1.py)
            from ..ops import v1

            self._D_source = jnp.asarray(
                v1.generate_D_half(param, self.Pk, pk_n2)
            )

    # -- phases --------------------------------------------------------
    def phi_kspace(self):
        """f_NL round trip -> phi(k) with local non-Gaussianity applied."""
        p = self.param
        phi_cfg = SynthConfig.from_params(p, self.Pk.fixed_power)
        phi_k = synthesize_full_fast(
            phi_cfg,
            self.tables,
            dtype=self.dtype,
            gen_phi=True,
            D_source=self._D_source,
        )[0]
        return _phi_nonlinear(phi_k, self.dtype(p.f_NL))

    def kspace(self):
        """The packed k-space arrays (narray, ppd, ppd, ppd)."""
        p = self.param
        phi_k = self.phi_kspace() if p.f_NL != 0 else None
        return synthesize_full_fast(
            self.cfg,
            self.tables,
            dtype=self.dtype,
            phi_k=phi_k,
            D_source=self._D_source,
        )

    def xspace(self, kgrid=None):
        """Inverse-FFT'd configuration-space arrays (narray, y, z, x)."""
        if kgrid is None:
            kgrid = self.kspace()
        return _ifft_all(kgrid)

    # -- complex-free phases (real (re, im) pairs + matmul FFT) ---------
    # The real-pair route (--pair, --dtype df64): FFTs become dense
    # matmuls (ops/mmfft).
    @property
    def pk_eff(self):
        """Cached static amplitude field for the pair path (setup work)."""
        if getattr(self, "_pk_eff", None) is None:
            from ..ops.modes_real import pk_effective

            self._pk_eff = jax.jit(
                pk_effective, static_argnames=("cfg", "dtype")
            )(self.cfg, self.tables, dtype=self.dtype)
        return self._pk_eff

    def kspace_pair(self):
        """Packed k-space arrays as real pairs: (narray, 2, Y, Z, X)."""
        from ..ops import mmfft
        from ..ops.modes_real import synthesize_full_fast_pair

        if self._D_source is not None:
            raise NotImplementedError(
                "ZD_Version=1 uses the host/complex path"
            )
        p = self.param
        phi_pair = None
        if p.f_NL != 0:
            phi_k = synthesize_full_fast_pair(
                self.cfg,
                self.tables,
                dtype=self.dtype,
                gen_phi=True,
                pk_eff=self.pk_eff,
            )[0]
            phi_x = mmfft.ifft3_pair(phi_k)[0]
            phi_x = (phi_x + self.dtype(p.f_NL) * phi_x * phi_x) * self.dtype(
                1.0 / p.ppd**3
            )
            phi_pair = mmfft.fft3_pair(
                jnp.stack([phi_x, jnp.zeros_like(phi_x)])
            )
        return synthesize_full_fast_pair(
            self.cfg,
            self.tables,
            dtype=self.dtype,
            phi_pair=phi_pair,
            pk_eff=self.pk_eff,
        )

    # -- half-spectrum (c2r) phases: the pair route's single-device form --
    # Never materializes the Hermitian mirror half: z/x transforms run on
    # (half+1)/ppd of the data, the y transform is a c2r matmul.  ~2.2x
    # fewer FFT flops and half the k-space memory vs the full pair grid.
    @property
    def half_exact(self) -> bool:
        """Whether the c2r half-spectrum form reproduces the full grid.

        False when the spectrum is not exactly Hermitian and the c2r
        transform would project out reference-matching leakage:
        - f_NL: the input-phi pass repopulates Nyquist modes
          unconditionally (zeldovich.cpp:393-400);
        - CornerModes with k_cutoff != 1: the self-conjugate z/x-Nyquist
          lines of the ky=0 plane escape every zero rule and draw
          independent (non-conjugate) modes, exactly as the reference's
          structural mirroring leaves them (measured 0.5%-of-scale
          half-vs-full discrepancy at 16^3);
        - ZD_Version=1 (host-generated, complex path only).
        """
        p = self.param
        return (
            p.f_NL == 0
            and self._D_source is None
            and not (p.CornerModes and p.k_cutoff != 1)
        )

    def kspace_half_pair(self):
        """Half-spectrum pm-pairs (narray, 2, 2, half+1, Z, X).

        Only valid when ``half_exact`` (see there); other configurations
        keep the full-grid pair path for elementwise parity.
        """
        from ..ops.modes_real import synthesize_half_pair

        if self._D_source is not None:
            raise NotImplementedError("ZD_Version=1 uses the complex path")
        if not self.half_exact:
            raise NotImplementedError(
                "non-Hermitian configuration uses the full-grid pair path"
            )
        return synthesize_half_pair(
            self.cfg, self.tables, dtype=self.dtype, pk_eff=self.pk_eff
        )

    def xspace_half_pair(self, spm=None):
        """Half-spectrum forward: same output as xspace_pair.

        Falls back to the full-grid pair path for configurations the
        half-spectrum form cannot represent (f_NL, ZD_Version=1).
        """
        from ..ops import mmfft

        if spm is None:
            if not self.half_exact:
                return self.xspace_pair()
            return _half_pair_forward(
                self.cfg, self.tables, self.pk_eff, self.dtype
            )
        return mmfft.ifft3_half_pair(spm)

    def xspace_half_df64(self):
        """Mixed-precision parity mode (the ``--dtype df64`` path).

        Exact-primitive float32 draw chain (the integer part is exact in
        every dtype; the float rounding is ~1e-7 per mode) + float64-grade
        two-float transforms (Ozaki int8 matmuls, ops/ozaki.py), within
        the <1e-6 displacement-parity target.  Falls back to the full f64
        pair path for f_NL / ZD_Version=1 (where the half form is
        excluded).
        """
        if not self.half_exact:
            return Zeldovich(self.param, dtype=jnp.float64).xspace_pair()
        return _half_df64_forward(self.cfg, self.tables, self.pk_eff)

    def xspace_pair(self, kpair=None):
        """Complex-free inverse FFT: (narray, 2, Y, Z, X) real arrays."""
        from ..ops import mmfft

        if kpair is None:
            if self.param.f_NL == 0:
                # argument-passing jitted step: large operands (pk_eff)
                # must not be closure constants (they bloat the HLO)
                return _pair_forward(
                    self.cfg, self.tables, self.pk_eff, self.dtype
                )
            kpair = self.kspace_pair()
        x = mmfft.ifft3_pair(jnp.swapaxes(kpair, 0, 1))
        return jnp.swapaxes(x, 0, 1)

    def run_pair(self, setup_dir: bool = True) -> OutputWriter:
        """Full run through the complex-free (half-spectrum) path."""
        from ..utils.streamio import stream_xspace

        p = self.param
        if setup_dir:
            setup_output_dir(p)
        writer = OutputWriter(p)
        stream_xspace(self.xspace_half_pair(), writer, pair=True)
        writer.report(self.Pk)
        return writer

    # -- sharded phases (multi-device: mesh over ("z", "y")) ------------
    def kspace_sharded(self, mesh):
        """Packed k-space arrays sharded (None, "y", "z", None) on mesh."""
        from ..parallel.pencil_fft import fft3_sharded, ifft3_sharded
        from ..parallel.synthesis import synthesize_sharded

        if self._D_source is not None:
            raise NotImplementedError(
                "ZD_Version=1 is a legacy back-compat path; use the "
                "single-host pipeline (its phases depend on ZD_NumBlock "
                "and it is host-generated)"
            )
        p = self.param
        phi_k = None
        if p.f_NL != 0:
            phi4 = synthesize_sharded(
                self.cfg, self.tables, mesh, dtype=self.dtype, gen_phi=True
            )
            n = p.ppd
            phi_x = ifft3_sharded(phi4, mesh).real
            phi_x = (phi_x + self.dtype(p.f_NL) * phi_x * phi_x) * (1.0 / n**3)
            phi_k = fft3_sharded(phi_x.astype(self.cdtype), mesh)[0]
        return synthesize_sharded(
            self.cfg, self.tables, mesh, dtype=self.dtype, phi_k=phi_k
        )

    def xspace_sharded(self, mesh, kgrid=None):
        """Sharded end-to-end forward: synthesis + pencil inverse FFT.

        The final transform uses the transpose-light (2-all-to-all) form,
        leaving the result in x-pencil layout -- the same global array with
        a different sharding, which the host-gathering output stage (or any
        layout-agnostic consumer) reads identically.
        """
        from ..parallel.pencil_fft import ifft3_sharded_final

        if kgrid is None:
            kgrid = self.kspace_sharded(mesh)
        return ifft3_sharded_final(kgrid, mesh)

    def kspace_pair_sharded(self, mesh):
        """Sharded complex-free k-space: (narray, 2, Y, Z, X) pairs.

        This is the PART1/PART2 boundary for the sharded pair path.
        """
        from ..parallel.pencil_mmfft import fft3_pair_sharded, ifft3_pair_sharded
        from ..parallel.synthesis import synthesize_sharded_pair

        if self._D_source is not None:
            raise NotImplementedError("ZD_Version=1 uses the host path")
        p = self.param
        phi_pair = None
        if p.f_NL != 0:
            phi_k = synthesize_sharded_pair(
                self.cfg, self.tables, mesh, dtype=self.dtype, gen_phi=True
            )[0]
            phi_x = ifft3_pair_sharded(phi_k, mesh)[0]
            phi_x = (phi_x + self.dtype(p.f_NL) * phi_x * phi_x) * self.dtype(
                1.0 / p.ppd**3
            )
            phi_pair = fft3_pair_sharded(
                jnp.stack([phi_x, jnp.zeros_like(phi_x)]), mesh
            )
        return synthesize_sharded_pair(
            self.cfg, self.tables, mesh, dtype=self.dtype, phi_pair=phi_pair
        )

    def xspace_pair_sharded(self, mesh, kpair=None):
        """Sharded complex-free forward: (narray, 2, Y, Z, X) pairs."""
        from ..parallel.pencil_mmfft import ifft3_pair_sharded_final

        if kpair is None:
            kpair = self.kspace_pair_sharded(mesh)
        x = ifft3_pair_sharded_final(jnp.swapaxes(kpair, 0, 1), mesh)
        return jnp.swapaxes(x, 0, 1)

    @property
    def can_fuse_zplanes(self) -> bool:
        """Whether xspace_half_pair_sharded honors zplanes=True.

        The non-half fallback returns an x-pencil-sharded grid (zplanes
        is ignored there); callers relying on z-plane output layout must
        check this instead of duplicating the eligibility conditions.
        """
        return self.half_exact

    @property
    def pk_eff_half_src(self):
        """Cached source-resolved amplitude field (pk_effective_half_src)."""
        if getattr(self, "_pk_eff_half_src", None) is None:
            from ..ops.modes_real import pk_effective_half_src

            self._pk_eff_half_src = jax.jit(
                pk_effective_half_src, static_argnames=("cfg", "dtype")
            )(self.cfg, self.tables, dtype=self.dtype)
        return self._pk_eff_half_src

    def xspace_half_pair_sharded(self, mesh, zplanes: bool = False):
        """Sharded half-spectrum forward (2 all-to-alls total).

        f_NL falls back to the full-grid pair pencil path (the input-phi
        pass is not exactly Hermitian; the fallback ignores ``zplanes`` --
        its result is x-pencil-sharded).  ZD_Version=1 has no sharded pair
        path at all (host-generated, sequential by construction).
        """
        if self._D_source is not None:
            raise NotImplementedError(
                "ZD_Version=1 is host-generated; use the single-host "
                "complex pipeline"
            )
        if not self.half_exact:
            return self.xspace_pair_sharded(mesh)
        from ..parallel.pencil_mmfft import xspace_half_pair_sharded

        pk = self.pk_eff_half_src
        if jax.process_count() > 1:
            # multi-controller: inputs must be global arrays (the x-split
            # spec the kernel expects; identical host values per process)
            import numpy as np
            from jax.sharding import NamedSharding, PartitionSpec as P

            pk = jax.device_put(
                np.asarray(pk),
                NamedSharding(mesh, P(None, None, ("z", "y"))),
            )
        return xspace_half_pair_sharded(
            self.cfg, self.tables, pk, mesh, self.dtype, zplanes=zplanes
        )

    def xspace_half_df64_sharded(self, mesh, zplanes: bool = False):
        """The --dtype df64 parity mode on a device mesh.

        Fused sharded half-spectrum step (2 all-to-alls) with the
        exact-primitive f32 draw chain and two-float int8 transforms;
        output is (narray, 2, Y, Z, X) float64.  Non-Hermitian
        configurations (f_NL, CornerModes+k_cutoff) fall back to the
        full-f64 sharded pair path -- same parity, pencil dataflow
        (the fallback ignores ``zplanes``; see can_fuse_zplanes).
        """
        if self._D_source is not None:
            raise NotImplementedError(
                "ZD_Version=1 is host-generated; use the single-host "
                "complex pipeline"
            )
        if not self.half_exact:
            return Zeldovich(self.param, dtype=jnp.float64).xspace_pair_sharded(
                mesh
            )
        from ..parallel.pencil_mmfft import xspace_half_df64_sharded

        pk = self.pk_eff_half_src.astype(jnp.float32)
        if jax.process_count() > 1:
            import numpy as np
            from jax.sharding import NamedSharding, PartitionSpec as P

            pk = jax.device_put(
                np.asarray(pk),
                NamedSharding(mesh, P(None, None, ("z", "y"))),
            )
        return xspace_half_df64_sharded(
            self.cfg, self.tables, pk, mesh, zplanes=zplanes
        )

    # -- full run ------------------------------------------------------
    def run(self, setup_dir: bool = True) -> OutputWriter:
        from ..utils.streamio import stream_xspace

        p = self.param
        if setup_dir:
            setup_output_dir(p)
        writer = OutputWriter(p)
        stream_xspace(self.xspace(), writer)
        writer.report(self.Pk)
        return writer


@jax.jit
def _ifft_all(kgrid):
    return fft.ifft3(kgrid, axes=(1, 2, 3))


@partial(jax.jit, static_argnames=("cfg", "dtype"))
def _half_pair_forward(cfg, tables, pk_eff, dtype):
    """Fused half-spectrum forward step (synthesis + c2r matmul iFFT)."""
    from ..ops import mmfft
    from ..ops.modes_real import synthesize_half_pair

    spm = synthesize_half_pair(cfg, tables, dtype=dtype, pk_eff=pk_eff)
    return mmfft.ifft3_half_pair(spm)


@partial(jax.jit, static_argnames=("cfg",))
def _half_df64_forward(cfg, tables, pk_eff):
    """Mixed parity step: f32 half-spectrum synthesis + f64 c2r transforms."""
    from ..ops import mmfft
    from ..ops.modes_real import synthesize_half_pair

    spm = synthesize_half_pair(
        cfg,
        tables,
        dtype=jnp.float32,
        pk_eff=pk_eff.astype(jnp.float32),
        accurate=True,
    )
    return mmfft.ifft3_half_df64(spm)


@partial(jax.jit, static_argnames=("cfg", "dtype"))
def _pair_forward(cfg, tables, pk_eff, dtype):
    """Fused complex-free forward step (synthesis + matmul iFFT)."""
    from ..ops import mmfft
    from ..ops.modes_real import synthesize_full_fast_pair

    k = synthesize_full_fast_pair(cfg, tables, dtype=dtype, pk_eff=pk_eff)
    x = mmfft.ifft3_pair(jnp.swapaxes(k, 0, 1))
    return jnp.swapaxes(x, 0, 1)


@partial(jax.jit, static_argnames=())
def _phi_nonlinear(phi_k, f_NL):
    """phi(k) -> config space -> phi + f_NL phi^2 -> back to k space.

    Matches ZeldovichXY_Phi: the inverse FFT is unnormalized, so the
    round-trip 1/ppd^3 is folded into the non-linear map
    (zeldovich.cpp:749-759).
    """
    n = phi_k.shape[-1]
    phi_x = fft.ifft3(phi_k).real
    phi_x = (phi_x + f_NL * phi_x * phi_x) * (1.0 / n**3)
    return fft.fft3(phi_x.astype(phi_k.dtype))
