"""FM-index over forward+reverse-complement text, in TPU-friendly layout.

Role of the reference's FMI_search/lbwt index (bwa-mem2-lcp/src/bwt.h:64-76,
ext/TAL/src/FMI/FMI_search.h:65-84): the index text is X = T + revcomp(T)
(sentinel-terminated), so bi-directional SMEM extension works with backward
extension only (bwa's FMD bi-interval trick, src/bwt.cpp bwt_extend
semantics).

TPU layout decisions (vs the reference's CPU layout):
  * One fused checkpoint row per 32 suffixes holding BOTH orders of rank
    data — the TPU analogue of the fork's ``Occline`` (src/bwt.h:64-67:
    16 dinucleotide counts + bitplanes of the last two BWT columns per
    128 suffixes). Our row: 4 single-char cumulative counts, 16
    dinucleotide cumulative counts, 2 packed words of the last BWT
    column B, 2 packed words of the second-to-last column B1. A single
    gather row therefore answers 1-step AND 2-step rank queries — XLA
    TPU gathers are row-count-bound, so the wider row is free while the
    dependent-gather chain halves (the point of the fork's 2-step
    "lambert" extension, src/bwt.cpp:278-1065).
  * In-block ranks are vectorized 2-bit compares + popcounts on the VPU
    (the analogue of the reference's 64-bit one-hot popcounts, CP_OCC,
    FMI_search.h:77-84); dinucleotide ranks AND the B and B1 bitplane
    masks exactly like forwardExtensionTwoStepFsRs1 (src/bwt.cpp:278).
  * Full int32 suffix array (single gather per seed; the reference's
    packed 34-bit sa_low32/sa_high2, bwt.h:72-76, is the >2^31 upgrade
    path).
  * Sentinel handling: the sentinel is excluded from the packed words'
    alphabet (encoded as code 0). Two rows carry spurious pairs — the
    sentinel row r0 (B = $) and the SA==1 row r1 (B1 = $); queries
    subtract them via (cc, row) correction scalars.

The c2Array[16] dinucleotide cumulative of the fork (lbwt_t, bwt.h:76) is
``c2`` here (17 entries, exact first-row-per-dinucleotide).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import dna
from .suffix_array import bwt_from_sa, suffix_array

OCC_BLOCK = 32  # BWT codes per occ checkpoint (two uint32 words per column)


@dataclasses.dataclass
class FMIndex:
    """Host-side FM-index arrays (numpy). See module docstring for layout."""

    n_ref: int                # forward reference length n; text X has 2n chars
    text_len: int             # N = 2n + 1 (incl. sentinel row count in BWT)
    sentinel_row: int         # BWT row holding the sentinel (SA == 0); r0
    r1_row: int               # BWT row with SA == 1 (B1 = sentinel)
    counts: np.ndarray        # int64[5]: C[c] = 1 + #{chars in X < c}
    c2: np.ndarray            # int64[17]: first BWT row of dinucleotide c1c2
    occ: np.ndarray           # int32[nblocks, 4] cumulative counts at blocks
    occ2: np.ndarray          # int32[nblocks, 16] dinucleotide cumulatives
    bwt_words: np.ndarray     # uint32[nblocks, 2] packed B codes
    bwt1_words: np.ndarray    # uint32[nblocks, 2] packed B1 codes
    cc_r0: int                # spurious pair code at sentinel_row
    cc_r1: int                # spurious pair code at r1_row
    sa: np.ndarray            # int32[N] full suffix array

    # ---- construction ----

    @classmethod
    def build(cls, ref_codes: np.ndarray) -> "FMIndex":
        assert ref_codes.max(initial=0) <= 3, "randomize ambiguous bases first"
        n = len(ref_codes)
        x = np.concatenate([ref_codes, dna.revcomp(ref_codes)]).astype(np.uint8)
        sa2n = suffix_array(x)
        bwt, sentinel_row, full_sa = bwt_from_sa(x, sa2n)
        big_n = 2 * n + 1
        assert big_n < 2**31, "int32 SA layout requires text < 2^31 (shard larger refs)"

        # C array: sentinel (rank 0) + cumulative symbol counts of X
        sym_counts = np.bincount(x, minlength=4)[:4]
        counts = np.zeros(5, dtype=np.int64)
        counts[0] = 1
        counts[1:] = 1 + np.cumsum(sym_counts)
        # counts[c] = first SA row of suffixes starting with c; counts[4] = N

        # second-to-last BWT column B1: char two before each suffix.
        # p2 == big_n-1 is the $ position (exactly the SA==1 row).
        p2 = (full_sa + big_n - 2) % big_n
        r1_row = int(np.nonzero(full_sa == 1)[0][0])
        bwt1 = np.zeros(big_n, dtype=np.uint8)
        real1 = p2 < big_n - 1
        bwt1[real1] = x[p2[real1]]
        cc_r0 = int(bwt1[sentinel_row]) * 4 + 0   # B packs $ as 0 at r0
        cc_r1 = 0 * 4 + int(bwt[r1_row])          # B1 packs $ as 0 at r1

        # c2 cumulative: first row of each dinucleotide prefix, from the
        # (sorted) first-two-chars keys; $ sorts first (key offset +1)
        xi = x.astype(np.int64)
        f0 = np.where(full_sa == big_n - 1, -1, xi[np.minimum(full_sa, 2 * n - 1)])
        nxt = full_sa + 1
        f1 = np.where(nxt >= big_n - 1, -1, xi[np.minimum(nxt, 2 * n - 1)])
        key = (f0 + 1) * 5 + (f1 + 1)
        cc_keys = (np.arange(16) // 4 + 1) * 5 + (np.arange(16) % 4 + 1)
        c2 = np.zeros(17, dtype=np.int64)
        c2[:16] = np.searchsorted(key, cc_keys, side="left")
        c2[16] = big_n

        # occ checkpoints (placeholder code 0 at r0/r1 is counted here and
        # corrected at query time via sentinel_row / cc_r0 / cc_r1)
        nblocks = -(-big_n // OCC_BLOCK) + 1
        pad_n = nblocks * OCC_BLOCK
        onehot = np.zeros((pad_n, 4), dtype=np.int32)
        onehot[np.arange(big_n), bwt] = 1
        csum = onehot.reshape(nblocks, OCC_BLOCK, 4).sum(axis=1).cumsum(axis=0)
        occ = np.zeros((nblocks, 4), dtype=np.int32)
        occ[1:] = csum[:-1]

        pc = (bwt1.astype(np.int32) * 4 + bwt).astype(np.int32)
        onehot2 = np.zeros((pad_n, 16), dtype=np.int32)
        onehot2[np.arange(big_n), pc] = 1
        csum2 = onehot2.reshape(nblocks, OCC_BLOCK, 16).sum(axis=1).cumsum(axis=0)
        occ2 = np.zeros((nblocks, 16), dtype=np.int32)
        occ2[1:] = csum2[:-1]

        def pack2(codes):
            words = dna.pack_2bit_words(codes, 16)
            out = np.zeros(nblocks * 2, dtype=np.uint32)
            out[: len(words)] = words
            return out.reshape(nblocks, 2)

        return cls(
            n_ref=n, text_len=big_n, sentinel_row=sentinel_row,
            r1_row=r1_row, counts=counts, c2=c2, occ=occ, occ2=occ2,
            bwt_words=pack2(bwt), bwt1_words=pack2(bwt1),
            cc_r0=cc_r0, cc_r1=cc_r1,
            sa=full_sa.astype(np.int32),
        )

    # ---- host-side rank / search (oracle + build verification) ----

    def _code_at(self, words, j: int) -> int:
        blk, rem = divmod(int(j), OCC_BLOCK)
        word = int(words[blk, rem // 16])
        return (word >> (2 * (rem % 16))) & 3

    def occ_at(self, c: int, i: int) -> int:
        """# occurrences of code c in BWT[0:i], sentinel excluded."""
        blk, rem = divmod(int(i), OCC_BLOCK)
        cnt = int(self.occ[blk, c])
        for j in range(rem):
            if self._code_at(self.bwt_words, blk * OCC_BLOCK + j) == c:
                cnt += 1
        if c == 0 and i > self.sentinel_row:
            cnt -= 1
        return cnt

    def occ2_at(self, cc: int, i: int) -> int:
        """# rows j < i with dinucleotide (B1[j], B[j]) == (cc>>2, cc&3),
        sentinel-containing pairs excluded."""
        blk, rem = divmod(int(i), OCC_BLOCK)
        cnt = int(self.occ2[blk, cc])
        for j in range(rem):
            p = blk * OCC_BLOCK + j
            pj = self._code_at(self.bwt1_words, p) * 4 + \
                self._code_at(self.bwt_words, p)
            if pj == cc:
                cnt += 1
        if cc == self.cc_r0 and i > self.sentinel_row:
            cnt -= 1
        if cc == self.cc_r1 and i > self.r1_row:
            cnt -= 1
        return cnt

    def backward_extend(self, k: int, l: int, s: int, c: int):
        """Prepend code c to the pattern (bi-interval). Mirrors bwa
        bwt_extend(is_back=1) semantics (reference src/bwt.cpp)."""
        tk = [self.occ_at(d, k) for d in range(4)]
        tl = [self.occ_at(d, k + s) for d in range(4)]
        sizes = [tl[d] - tk[d] for d in range(4)]
        sent_in = 1 if (k <= self.sentinel_row < k + s) else 0
        # l-intervals accumulate in complement (descending code) order
        l3 = l + sent_in
        l2 = l3 + sizes[3]
        l1 = l2 + sizes[2]
        l0 = l1 + sizes[1]
        new_l = [l0, l1, l2, l3][c]
        new_k = int(self.counts[c]) + tk[c]
        return new_k, new_l, sizes[c]

    def backward_extend2(self, k: int, s: int, c1: int, c2: int):
        """Prepend TWO codes at once (pattern becomes c1 c2 P): the fork's
        backwardExtensionTwoStepFs (src/bwt.cpp:822-1065). Returns
        (new_k, new_s); the RC bound is not produced (dead in the
        backward SMEM phase)."""
        cc = c1 * 4 + c2
        o_lo = self.occ2_at(cc, k)
        o_hi = self.occ2_at(cc, k + s)
        return int(self.c2[cc]) + o_lo, o_hi - o_lo

    def forward_extend(self, k: int, l: int, s: int, c: int):
        """Append code c to the pattern (extend right)."""
        nl, nk, ns = self.backward_extend(l, k, s, 3 - c)
        return nk, nl, ns

    def forward_extend2(self, k: int, l: int, s: int, ca: int, cb: int):
        """Append TWO codes (pattern P -> P·ca·cb): the fork's
        forwardExtensionTwoStepFsRs (src/bwt.cpp:278-649). Returns the
        intermediate bi-interval after ca and the final after ca·cb:
        ((k1, l1, s1), (k2, l2, s2))."""
        k1, l1, s1 = self.forward_extend(k, l, s, ca)
        # RC(P·ca·cb) = (3-cb)(3-ca)·RC(P): a 2-step prepend on the l side
        cc = (3 - cb) * 4 + (3 - ca)
        l2 = int(self.c2[cc]) + self.occ2_at(cc, l)
        s2 = self.occ2_at(cc, l + s) - self.occ2_at(cc, l)
        # forward sub-partition of [k1, k1+s1): '$' continuation first,
        # then continuations in increasing char order
        s2fwd = [self.occ2_at((3 - d) * 4 + (3 - ca), l + s)
                 - self.occ2_at((3 - d) * 4 + (3 - ca), l) for d in range(4)]
        end2 = s1 - sum(s2fwd)
        k2 = k1 + end2 + sum(s2fwd[d] for d in range(cb))
        return (k1, l1, s1), (k2, l2, s2)

    def init_interval(self, c: int):
        k = int(self.counts[c])
        s = int(self.counts[c + 1] - self.counts[c])
        l = int(self.counts[3 - c])
        return k, l, s

    # ---- serialization (the index artifacts are the checkpoint format,
    # like the reference's .bwt/.sa/.0123 files, bwtindex.cpp:318-363) ----

    def save(self, path):
        np.savez(
            path, n_ref=self.n_ref, text_len=self.text_len,
            sentinel_row=self.sentinel_row, r1_row=self.r1_row,
            counts=self.counts, c2=self.c2, occ=self.occ, occ2=self.occ2,
            bwt_words=self.bwt_words, bwt1_words=self.bwt1_words,
            cc_r0=self.cc_r0, cc_r1=self.cc_r1, sa=self.sa,
        )

    @classmethod
    def load(cls, path) -> "FMIndex":
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        return cls(
            n_ref=int(z["n_ref"]), text_len=int(z["text_len"]),
            sentinel_row=int(z["sentinel_row"]), r1_row=int(z["r1_row"]),
            counts=z["counts"], c2=z["c2"], occ=z["occ"], occ2=z["occ2"],
            bwt_words=z["bwt_words"], bwt1_words=z["bwt1_words"],
            cc_r0=int(z["cc_r0"]), cc_r1=int(z["cc_r1"]), sa=z["sa"],
        )
