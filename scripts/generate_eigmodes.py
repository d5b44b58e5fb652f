#!/usr/bin/env python
"""Generate a PLT eigenmode table (reference eigmodes128-compatible format).

Usage: python scripts/generate_eigmodes.py N OUTPUT [--alpha A]

Computes the Ewald-summed dynamical matrix of the gravitating simple-cubic
lattice for every k of an N^3 grid half-space, extracts the growing mode,
and writes the binary table consumed by ZD_PLT_filename.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("N", type=int)
    ap.add_argument("output")
    ap.add_argument("--alpha", type=float, default=2.0)
    args = ap.parse_args()

    from zeldovich.ops.lattice import generate_eigmodes_table
    from zeldovich.ops.plt import save_eigmodes

    t0 = time.time()
    table = generate_eigmodes_table(args.N, alpha=args.alpha, verbose=True)
    save_eigmodes(args.output, table)
    print(f"wrote {args.output} ({args.N}^3 half-space) in {time.time()-t0:.1f} s")


if __name__ == "__main__":
    main()
