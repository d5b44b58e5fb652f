"""Compare a generated eigenmode table against an upstream eigmodes128 blob.

The reference ships ``eigmodes128`` as a precomputed data blob (loaded at
/root/reference/src/zeldovich.cpp:794-830; STRIPPED in this build
environment, so the comparison cannot run here).  This repo regenerates
the table from first principles (zeldovich/ops/lattice.py, Ewald
sums of the SC-lattice dynamical matrix per Marcos et al. 2006 /
Garrison et al. 2016).  When an upstream blob is available, this script
is the one-command external cross-validation:

    python scripts/compare_eigmodes.py /path/to/upstream/eigmodes128

It compares eigenvalues directly and eigenvectors up to sign (the
growing-mode sign convention is ours; the projection uses k^2/(k.e)
which is sign-invariant) and reports max/rms deviations.  Exit 0 iff
eigenvalues agree to 1e-6 and |e_ours . e_theirs| to 1e-6.

In-environment substitutes (tests/test_lattice.py): Kohn sum rule,
continuum limit, exact corner isotropy eps = I/3, Ewald-parameter
independence, an independent numeric-Hessian derivation of the real-
space tensor, and pinned X-point / spectrum statistics.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def load_table(path):
    raw = np.fromfile(path, dtype=np.uint8)
    ppd = int(np.frombuffer(raw[:4], np.int32)[0])
    n = ppd * ppd * (ppd // 2 + 1) * 4
    body = np.frombuffer(raw[4 : 4 + 8 * n], np.float64)
    return ppd, body.reshape(ppd, ppd, ppd // 2 + 1, 4)


def main(argv):
    if len(argv) != 2:
        print(__doc__)
        return 2
    theirs_path = argv[1]
    ppd, theirs = load_table(theirs_path)
    ours_path = (
        Path(__file__).parent.parent
        / "zeldovich" / "assets" / f"eigmodes{ppd}"
    )
    if ours_path.exists():
        _, ours = load_table(ours_path)
    else:
        from zeldovich.ops.lattice import generate_eigmodes_table

        print(f"generating {ppd}^3 table (no local asset)...", flush=True)
        ours = generate_eigmodes_table(ppd, verbose=True)

    mask = np.ones(theirs.shape[:3], bool)
    mask[0, 0, 0] = False  # k = 0 entry is conventional in both
    dval = np.abs(ours[..., 3] - theirs[..., 3])[mask]
    dot = np.abs(np.einsum("...i,...i->...", ours[..., :3], theirs[..., :3]))
    dvec = np.abs(1.0 - dot)[mask]
    print(f"eigenvalue  max|diff| = {dval.max():.3e}  rms = "
          f"{np.sqrt((dval**2).mean()):.3e}")
    print(f"eigenvector max|1-|e.e'|| = {dvec.max():.3e}  rms = "
          f"{np.sqrt((dvec**2).mean()):.3e}")
    ok = dval.max() < 1e-6 and dvec.max() < 1e-6
    print("MATCH" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
