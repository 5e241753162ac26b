"""Learned index over suffix-array prefixes — the LISA/RMI analogue.

Host copy of the JAX package's index/rmi.py (numpy only); the port's
device form is ops/exact.DeviceRMI.

Role of the reference's LISA IPBWT+RMI engine (bwa-mem2-lcp/ext/TAL/src/
LISA-FMI/ipbwt_rmi.h:49 — `get_guess_from_rmi` :103, vectorized last-mile
`last_mile_from_guess` :104; models trained by ext/TAL/scripts/
build-rmi.linear_spline.linear.sh): replace K dependent occ-table rank
gathers with ONE model prediction + a short bounded search, resolving a
whole K-char chunk of backward search per lookup.

Design:
  * Key = the first K=13 suffix characters packed base-5 with a +1
    digit offset (past-end/sentinel = 0), so keys are int32 and their
    order equals suffix order INCLUDING short suffixes — no special
    cases. The key array in SA order is therefore sorted, and the
    (k, s) SA interval of any 13-char pattern is exactly
    [searchsorted(keys, q), searchsorted(keys, q+1)).
  * The reference's linear-spline root is a radix root here (the
    RadixSpline family): leaf = key >> shift needs no gather; each
    leaf holds a least-squares linear model + error bounds computed
    with the SAME float32 arithmetic the device uses (an unfused
    multiply, then an add), so the bounds are exact on the device.
  * Last-mile = lockstep binary search over the bounded window — a
    handful of row gathers replaces the AVX512 last-mile
    (ipbwt_rmi.h:95).
"""

from __future__ import annotations

import dataclasses

import numpy as np

RMI_K = 13                    # 5^13 < 2^31: packed key fits int32
_LEAF_BITS_DEFAULT = 14


def pack_keys(x: np.ndarray, sa: np.ndarray, k: int = RMI_K) -> np.ndarray:
    """Base-5 packed first-k chars of each suffix (SA order -> sorted).
    x: uint8 codes of the text (sentinel NOT included); sa int32[N] over
    N = len(x)+1 rows (row with sa == len(x) is the sentinel suffix)."""
    n = len(x)
    sa = np.asarray(sa, np.int64)
    key = np.zeros(len(sa), np.int64)
    for j in range(k):
        p = sa + j
        digit = np.where(p < n, x[np.minimum(p, n - 1)].astype(np.int64) + 1,
                         0)
        key = key * 5 + digit
    assert key.max(initial=0) < 2**31
    return key.astype(np.int32)


def pack_pattern(codes: np.ndarray, k: int = RMI_K):
    """Pack k pattern chars (codes 0-3) the same way; returns int"""
    key = 0
    for j in range(k):
        key = key * 5 + int(codes[j]) + 1
    return key


@dataclasses.dataclass
class RMIndex:
    """Host arrays; device form via DeviceRMI.from_host."""

    keys: np.ndarray          # int32[N] sorted packed suffix prefixes
    slope: np.ndarray         # f32[n_leaves], >= 0
    intercept: np.ndarray     # f32[n_leaves]
    err_lo: np.ndarray        # int32[n_leaves]: pos >= pred - err_lo
    err_hi: np.ndarray        # int32[n_leaves]: pos <= pred + err_hi
    starts: np.ndarray        # int32[n_leaves+1] leaf row ranges
    shift: int                # leaf = key >> shift
    k: int = RMI_K

    @classmethod
    def build(cls, x: np.ndarray, sa: np.ndarray, k: int = RMI_K,
              leaf_bits: int = _LEAF_BITS_DEFAULT) -> "RMIndex":
        keys = pack_keys(np.asarray(x, np.uint8), sa, k)
        n = len(keys)
        key_bits = max(int(keys[-1]).bit_length(), 1)
        shift = max(key_bits - leaf_bits, 0)
        n_leaves = (int(keys[-1]) >> shift) + 1 if n else 1
        leaf = keys.astype(np.int64) >> shift
        pos = np.arange(n, dtype=np.int64)
        slope = np.zeros(n_leaves, np.float32)
        intercept = np.zeros(n_leaves, np.float32)
        err_lo = np.zeros(n_leaves, np.int32)
        err_hi = np.zeros(n_leaves, np.int32)
        starts = np.searchsorted(leaf, np.arange(n_leaves + 1))
        for lf in range(n_leaves):
            a, b = starts[lf], starts[lf + 1]
            if a == b:
                intercept[lf] = np.float32(a)
                continue
            kk = keys[a:b].astype(np.float64)
            pp = pos[a:b].astype(np.float64)
            if kk[-1] > kk[0]:
                var = np.dot(kk - kk.mean(), kk - kk.mean())
                m = np.dot(kk - kk.mean(), pp - pp.mean()) / var \
                    if var > 0 else 0.0
                m = max(m, 0.0)     # monotone data; keeps window proofs
                c = pp.mean() - m * kk.mean()
            else:
                m, c = 0.0, float(a)
            slope[lf] = np.float32(m)
            intercept[lf] = np.float32(c)
            # error bounds under the device's f32 arithmetic
            pred = (keys[a:b].astype(np.float32) * slope[lf]
                    + intercept[lf]).astype(np.int32)
            err_lo[lf] = int(np.max(pred - pos[a:b]))
            err_hi[lf] = int(np.max(pos[a:b] - pred))
        return cls(keys=keys, slope=slope, intercept=intercept,
                   err_lo=err_lo, err_hi=err_hi,
                   starts=starts.astype(np.int32), shift=shift, k=k)

    # ---- persistence (index artifact, like the reference's RMI blobs,
    # FMI_search.cpp:617-618 / LISA_search.h ctor) ----

    def save(self, path: str):
        np.savez(path, keys=self.keys, slope=self.slope,
                 intercept=self.intercept, err_lo=self.err_lo,
                 err_hi=self.err_hi, starts=self.starts,
                 meta=np.asarray([self.shift, self.k], np.int64))

    @classmethod
    def load(cls, path: str) -> "RMIndex":
        z = np.load(path if str(path).endswith(".npz") else path + ".npz")
        return cls(keys=z["keys"], slope=z["slope"],
                   intercept=z["intercept"], err_lo=z["err_lo"],
                   err_hi=z["err_hi"], starts=z["starts"],
                   shift=int(z["meta"][0]), k=int(z["meta"][1]))

    # ---- host reference lookup (oracle for tests) ----

    def lookup_host(self, qkey: int):
        lo = int(np.searchsorted(self.keys, qkey, side="left"))
        hi = int(np.searchsorted(self.keys, qkey, side="right"))
        return lo, hi - lo
