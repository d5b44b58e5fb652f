"""PLT dynamical-matrix physics checks."""

import numpy as np
import pytest

from zeldovich.ops.lattice import (
    dynamical_matrix,
    generate_eigmodes_table,
    growing_mode,
)


def test_kohn_sum_rule():
    """tr eps(k) = 1 for all k != 0 (exact for 1/r^2 forces)."""
    rng = np.random.default_rng(0)
    ks = rng.uniform(-np.pi, np.pi, size=(30, 3))
    eps = dynamical_matrix(ks)
    np.testing.assert_allclose(np.trace(eps, axis1=-2, axis2=-1), 1.0, atol=1e-12)


def test_continuum_limit():
    """k -> 0: growing eigenvalue -> 1, eigenvector -> k_hat."""
    k = np.array([[0.02, -0.013, 0.007]])
    khat = k / np.linalg.norm(k)
    v, w = growing_mode(dynamical_matrix(k), khat)
    assert w[0] == pytest.approx(1.0, abs=1e-4)
    assert np.dot(v[0], khat[0]) == pytest.approx(1.0, abs=1e-6)


def test_brillouin_corner_isotropic():
    """At k = (pi,pi,pi) all axes are equivalent: eps = I/3."""
    eps = dynamical_matrix(np.array([[np.pi, np.pi, np.pi]]))[0]
    np.testing.assert_allclose(eps, np.eye(3) / 3, atol=1e-10)


def test_axis_symmetry():
    """k along x: eigenvectors are the coordinate axes."""
    eps = dynamical_matrix(np.array([[2.0, 0.0, 0.0]]))[0]
    offdiag = eps - np.diag(np.diag(eps))
    np.testing.assert_allclose(offdiag, 0, atol=1e-12)
    assert eps[1, 1] == pytest.approx(eps[2, 2], rel=1e-12)


def test_ewald_parameter_independence():
    k = np.array([[1.0, -0.7, 0.3], [3.0, 2.9, -0.1]])
    e1 = dynamical_matrix(k, alpha=2.0, rcut=3.6, mcut=4)
    e2 = dynamical_matrix(k, alpha=2.6, rcut=3.0, mcut=6)
    np.testing.assert_allclose(e1, e2, atol=1e-12)


def test_reciprocal_lattice_periodicity():
    k = np.array([[0.9, -0.4, 0.2]])
    e1 = dynamical_matrix(k)
    e2 = dynamical_matrix(k + 2 * np.pi * np.array([[1, -2, 1]]))
    np.testing.assert_allclose(e1, e2, atol=1e-11)


def test_real_space_tensor_matches_numeric_hessian():
    """The Ewald real-space tensor's closed-form f'/f'' derivatives equal a
    numeric Hessian of erfc(alpha r)/r -- an independent derivation path,
    so an algebra slip in _real_space_tensor cannot hide."""
    from scipy.special import erfc as _erfc

    from zeldovich.ops.lattice import _real_space_tensor

    alpha = 2.0
    R, s = _real_space_tensor(alpha, rcut=2.2)

    def f(x):
        r = np.linalg.norm(x)
        return _erfc(alpha * r) / r

    h = 1e-5
    for idx in [0, 7, len(R) // 2, len(R) - 1]:
        x0 = R[idx]
        H = np.empty((3, 3))
        for a in range(3):
            for b in range(3):
                ea = np.eye(3)[a] * h
                eb = np.eye(3)[b] * h
                H[a, b] = (
                    f(x0 + ea + eb) - f(x0 + ea - eb)
                    - f(x0 - ea + eb) + f(x0 - ea - eb)
                ) / (4 * h * h)
        np.testing.assert_allclose(s[idx], -H, rtol=2e-5, atol=1e-7)


def test_high_symmetry_point_values():
    """Exact and pinned eigenvalues at Brillouin-zone symmetry points.

    Corner R = (pi,pi,pi): cubic symmetry + the Kohn sum rule force
    eps = I/3 exactly, so every eigenvalue is 1/3 (analytic, not a
    regression pin).

    X point (pi,0,0): the longitudinal eigenvalue is the SC lattice's
    MAXIMUM growth eigenvalue and the transverse pair is negative -- the
    classic simple-cubic transverse instability (Marcos et al. 2006) and
    the faster-than-fluid axis growth PLT corrects for (Garrison et al.
    2016, arXiv:1605.02333).  The numeric values are pinned to the
    generator's converged output (alpha/cutoff-independent per
    test_ewald_parameter_independence); qualitative structure
    (lambda_L > 1 > 0 > lambda_T, sum rule) is the physics claim.
    """
    corner = dynamical_matrix(np.array([[np.pi, np.pi, np.pi]]))[0]
    np.testing.assert_allclose(np.linalg.eigvalsh(corner), 1.0 / 3.0,
                               atol=1e-12)

    X = dynamical_matrix(np.array([[np.pi, 0.0, 0.0]]))[0]
    w = np.sort(np.linalg.eigvalsh(X))
    assert w[2] > 1.0 > 0.0 > w[0]          # fast longitudinal, unstable T
    assert w[0] == pytest.approx(w[1], abs=1e-12)  # transverse degeneracy
    assert w.sum() == pytest.approx(1.0, abs=1e-12)
    # pinned converged values (regression guard for the generator)
    assert w[2] == pytest.approx(1.1042355561, abs=1e-8)
    assert w[0] == pytest.approx(-0.0521177781, abs=1e-8)


def test_shipped_table_spectrum_statistics():
    """The regenerated eigmodes128 table's eigenvalue spectrum: bounded in
    [0.326, 1.105] with ~7.5% of modes growing faster than the continuum
    -- the spectrum shape PLT exists to correct (Garrison et al. 2016
    Fig. 1 shows exactly this faster-and-slower-than-fluid spread).
    Regression-pins the shipped asset so a regeneration with broken
    normalization (which internal invariants cannot catch) fails loudly.
    """
    from pathlib import Path

    path = (
        Path(__file__).parent.parent
        / "zeldovich" / "assets" / "eigmodes128"
    )
    if not path.exists():
        pytest.skip("eigmodes128 asset not present")
    raw = np.fromfile(path, dtype=np.uint8)
    ppd = int(np.frombuffer(raw[:4], np.int32)[0])
    t = np.frombuffer(raw[4:], np.float64).reshape(ppd, ppd, ppd // 2 + 1, 4)
    ev = t[..., 3]
    mask = np.ones_like(ev, bool)
    mask[0, 0, 0] = False  # the stored benign k=0 entry
    v = ev[mask]
    assert v.min() == pytest.approx(0.32605697, abs=1e-6)
    assert v.max() == pytest.approx(1.10423556, abs=1e-6)
    assert (v > 1).mean() == pytest.approx(0.0753, abs=0.002)
    # every stored eigenvector is unit-norm
    norms = np.linalg.norm(t[..., :3], axis=-1)[mask]
    np.testing.assert_allclose(norms, 1.0, atol=1e-12)


def test_table_generation_small():
    N = 8
    t = generate_eigmodes_table(N)
    assert t.shape == (N, N, N // 2 + 1, 4)
    # unit eigenvectors
    norms = np.linalg.norm(t[..., :3], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-10)
    # eigenvalues within the physical band (continuum 1, corner 1/3,
    # axis Nyquist ~1.1)
    assert t[..., 3].min() > -0.5
    assert t[..., 3].max() < 1.5
    # corner entry (index N/2 on each axis => k = (-pi,-pi,-pi), same D)
    assert t[N // 2, N // 2, N // 2, 3] == pytest.approx(1 / 3, abs=1e-9)
    # small-k plane: nearly continuum
    assert t[1, 0, 0, 3] == pytest.approx(1.0, abs=0.05)
    # eigenvector sign convention: e . khat >= 0
    half = N // 2
    ix = np.arange(N)
    wrap = np.where(ix > half, ix - N, ix)
    wrap = np.where(ix == half, -half, wrap)
    KX, KY, KZ = np.meshgrid(wrap, wrap, np.arange(half + 1), indexing="ij")
    dots = (
        t[..., 0] * KX + t[..., 1] * KY + t[..., 2] * KZ
    )
    assert (dots >= -1e-9).all()
