"""LCP-interval tree for single-pass SMEM enumeration.

The LISA fork's key seeding structure (reference ext/TAL/src/LISA-FMI/
LISA_search.h — lcpi/lcpp1 arrays :219-238, forward_shrink_phase
:297-333, all_SMEMs :365-385): SMEMs are enumerated right-to-left in ONE
pass per read — backward-extend until the interval empties, emit, then
ascend the suffix-tree (the "LCP shrink") to the deepest ancestor
interval whose string can be prepended with the failing character, and
keep extending. No per-pivot forward/backward restarts (bwa-mem's K1
does a forward pass + backward pass per pivot; ops/smem.py).

TPU-first layout (not the reference's bit-packed LcpInfo): one
int32[nrows+1, 4] row per SA boundary — (lcp, left, right, mask) —
so each shrink step is a single row gather per endpoint:
  lcp[b]   depth of the smallest lcp-interval strictly containing b
  left[b]/right[b]  its row span [left, right)
  mask[b]  4-bit backward-extendability of that interval
Construction is Kasai LCP + monotonic-stack prev/next-strictly-smaller
(native/fgdp_native.cc lcp_tree_arrays) + 8 vectorized rank lookups for
the masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io import native


@dataclasses.dataclass
class LcpTree:
    tree: np.ndarray     # int32[nrows+1, 4]: (lcp, left, right, mask)
    nrows: int           # SA rows (= text_len incl sentinel row)
    isa: np.ndarray = None  # int32[nrows] inverse SA (text pos -> row)

    @classmethod
    def build(cls, x: np.ndarray, full_sa: np.ndarray) -> "LcpTree":
        """x: uint8 text codes (fwd+revcomp, no sentinel); full_sa:
        int32[len(x)+1] incl. the sentinel row (sa[0] == len(x))."""
        x = np.ascontiguousarray(x, np.uint8)
        sa = np.ascontiguousarray(full_sa, np.int32)
        nrows = len(sa)
        assert nrows == len(x) + 1 and sa[0] == len(x)
        lcp, left, right = native.lcp_tree_arrays(x, sa)
        # BWT for the extendability masks (0 placeholder at the
        # sentinel row, excluded from the rank positions)
        prev = sa.astype(np.int64) - 1
        valid = prev >= 0
        bwt = np.zeros(nrows, np.uint8)
        bwt[valid] = x[prev[valid]]
        rows = np.arange(nrows)
        mask = np.zeros(nrows + 1, np.int32)
        for c in range(4):
            pos_c = rows[(bwt == c) & valid]
            occ_l = np.searchsorted(pos_c, left)
            occ_r = np.searchsorted(pos_c, right)
            mask |= (occ_r > occ_l).astype(np.int32) << c
        tree = np.stack([lcp, left, right, mask], axis=1).astype(np.int32)
        isa = np.zeros(nrows, np.int32)
        isa[sa] = np.arange(nrows, dtype=np.int32)
        return cls(tree=tree, nrows=nrows, isa=isa)

    def save(self, path: str):
        np.savez(path, tree=self.tree, nrows=np.int64(self.nrows),
                 isa=self.isa)

    @classmethod
    def load(cls, path: str) -> "LcpTree":
        z = np.load(path)
        isa = z["isa"] if "isa" in z.files else None
        return cls(tree=z["tree"], nrows=int(z["nrows"]), isa=isa)
