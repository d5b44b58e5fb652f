"""zeldovich-jax: an initial-conditions generator in JAX.

A brand-new JAX/XLA implementation with the full capabilities of the
zeldovich-PLT reference: Zel'dovich (1LPT) displacements/velocities with
resolution- and blocking-invariant phases (bit-exact pcg64 stream), PLT
eigenmode and rescaling corrections, local primordial non-Gaussianity,
phase-matched oversampling, and Abacus-compatible parameter files and
binary outputs.
"""

__version__ = "0.1.0"
