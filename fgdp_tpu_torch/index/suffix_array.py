"""Suffix-array construction (host side).

Plays the role of the reference's index builder (bwa-mem2-lcp uses BWT-SW
``bwt_bwtgen2`` + inverse-CSA SA sampling, src/bwtindex.cpp:197-233,
src/bwt.cpp:166). The full suffix array is built directly by the native
linear-time SA-IS (io/native.py).
"""

from __future__ import annotations

import numpy as np

from ..io import native


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """SA of `codes` (values >= 0) under sentinel-terminated comparison.

    Returns int64[n]: SA[r] = start of the r-th smallest suffix. The
    virtual terminator is smaller than any symbol, so a proper prefix
    sorts before its extensions (out-of-range rank key = -1).

    Runs the native linear-time SA-IS (native/fgdp_native.cc
    suffix_array_u8), which takes byte codes below 255.
    """
    n = len(codes)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    codes = np.asarray(codes)
    if codes.min(initial=0) < 0 or codes.max(initial=0) >= 255:
        raise ValueError("suffix_array takes codes in [0, 255)")
    return native.suffix_array_u8(codes.astype(np.uint8))


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray):
    """BWT of codes + sentinel.

    The BWT is over the n+1 rotations of (codes, $). Row 0 is the sentinel
    suffix. Returns (bwt_codes uint8[n+1], sentinel_row): bwt_codes holds a
    0 placeholder at sentinel_row (the row whose rotation ends with $,
    i.e. SA == 0); occ lookups correct for it via sentinel_row.
    """
    n = len(codes)
    full_sa = np.empty(n + 1, dtype=np.int64)
    full_sa[0] = n
    full_sa[1:] = sa
    prev = full_sa - 1  # char preceding each suffix
    bwt = np.zeros(n + 1, dtype=np.uint8)
    valid = prev >= 0
    bwt[valid] = codes[prev[valid]]
    sentinel_row = int(np.nonzero(~valid)[0][0])
    return bwt, sentinel_row, full_sa
