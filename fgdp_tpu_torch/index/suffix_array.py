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

