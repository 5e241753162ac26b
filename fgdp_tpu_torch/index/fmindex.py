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
from .suffix_array import suffix_array

OCC_BLOCK = 32  # BWT codes per occ checkpoint (two uint32 words per column)
# suffix-array rows a pass of FMIndex.build takes at a time (a multiple
# of OCC_BLOCK): it sets the size of the temporaries, not the result
BUILD_CHUNK = 1 << 18


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
    def build(cls, ref_codes: np.ndarray,
              chunk: int = BUILD_CHUNK) -> "FMIndex":
        """The index of ref_codes (0..3). Past the native SA-IS, one pass
        walks the suffix array `chunk` rows at a time, so the build holds
        the text (1 B a text position), the int32 SA (4 B), the occ rows
        (2.5 B) and the packed words (0.25 B), and no full-length
        temporary but the int64 SA while it is narrowed."""
        assert ref_codes.max(initial=0) <= 3, "randomize ambiguous bases first"
        if chunk <= 0 or chunk % OCC_BLOCK:
            raise ValueError("chunk must be a positive multiple of OCC_BLOCK")
        n = len(ref_codes)
        big_n = 2 * n + 1
        assert big_n < 2**31, "int32 SA layout requires text < 2^31 (shard larger refs)"
        x = np.empty(2 * n, np.uint8)              # X = T + revcomp(T)
        x[:n] = ref_codes
        x[n:] = x[:n][::-1]
        np.subtract(3, x[n:], out=x[n:])
        # row 0 is the sentinel suffix ($ sorts first); SA-IS's int64
        # rows are narrowed as they land
        sa = np.empty(big_n, np.int32)
        sa[0] = 2 * n
        sa[1:] = suffix_array(x)

        # C array: sentinel (rank 0) + cumulative symbol counts of X;
        # counts[c] = first SA row of suffixes starting with c; counts[4] = N
        sym_counts = np.zeros(4, np.int64)
        for a in range(0, 2 * n, chunk):
            sym_counts += np.bincount(x[a:a + chunk], minlength=4)[:4]
        counts = np.zeros(5, dtype=np.int64)
        counts[0] = 1
        counts[1:] = 1 + np.cumsum(sym_counts)

        # one pass over the rows: the last BWT column B (the char before
        # each suffix; a 0 placeholder at the sentinel row r0, SA == 0),
        # the second-to-last B1 (two before; $ packs as 0 at r1, SA ==
        # 1), their occ checkpoints and packed words, and the counts of
        # the first-two-chars keys ($ sorts first: key offset +1). The
        # placeholder code 0 at r0/r1 is counted in occ and corrected at
        # query time via sentinel_row / cc_r0 / cc_r1.
        nblocks = -(-big_n // OCC_BLOCK) + 1
        occ = np.zeros((nblocks, 4), dtype=np.int32)
        occ2 = np.zeros((nblocks, 16), dtype=np.int32)
        words = np.zeros((2, nblocks * 2), dtype=np.uint32)
        run, run2 = np.zeros(4, np.int64), np.zeros(16, np.int64)
        key_counts = np.zeros(25, np.int64)
        last = 2 * n - 1
        for a in range(0, big_n, chunk):
            s = sa[a:a + chunk]
            m = len(s)
            at0, at1 = np.flatnonzero(s == 0), np.flatnonzero(s == 1)
            bw = x[s - 1]
            bw[at0] = 0
            p2 = s - 2
            p2[at0] = last                         # r0: B1 is X[2n - 1]
            bw1 = x[p2]
            bw1[at1] = 0
            if len(at0):
                sentinel_row, r0_b1 = a + int(at0[0]), int(bw1[at0[0]])
            if len(at1):
                r1_row, r1_b = a + int(at1[0]), int(bw[at1[0]])
            f0 = x[np.minimum(s, last)].astype(np.int32) + 1
            f0[s == 2 * n] = 0
            f1 = x[np.minimum(s + 1, last)].astype(np.int32) + 1
            f1[s >= last] = 0
            key_counts += np.bincount(f0 * 5 + f1, minlength=25)
            nb = -(-m // OCC_BLOCK)
            blk = np.arange(m, dtype=np.int32) // OCC_BLOCK
            b0 = a // OCC_BLOCK + 1
            occ[b0:b0 + nb] = np.bincount(
                blk * 4 + bw, minlength=nb * 4).reshape(nb, 4).cumsum(
                    axis=0) + run
            occ2[b0:b0 + nb] = np.bincount(
                blk * 16 + bw1.astype(np.int32) * 4 + bw,
                minlength=nb * 16).reshape(nb, 16).cumsum(axis=0) + run2
            run, run2 = occ[b0 + nb - 1], occ2[b0 + nb - 1]
            w0, nw = a // 16, -(-m // 16)
            words[0, w0:w0 + nw] = dna.pack_2bit_words(bw, 16)
            words[1, w0:w0 + nw] = dna.pack_2bit_words(bw1, 16)

        # c2 cumulative: the first row of each dinucleotide prefix is the
        # number of rows whose (sorted) key is smaller
        cc_keys = (np.arange(16) // 4 + 1) * 5 + (np.arange(16) % 4 + 1)
        c2 = np.zeros(17, dtype=np.int64)
        c2[:16] = np.concatenate([[0], np.cumsum(key_counts)])[cc_keys]
        c2[16] = big_n

        return cls(
            n_ref=n, text_len=big_n, sentinel_row=sentinel_row,
            r1_row=r1_row, counts=counts, c2=c2, occ=occ, occ2=occ2,
            bwt_words=words[0].reshape(nblocks, 2),
            bwt1_words=words[1].reshape(nblocks, 2),
            cc_r0=r0_b1 * 4 + 0,                   # B packs $ as 0 at r0
            cc_r1=0 * 4 + r1_b,                    # B1 packs $ as 0 at r1
            sa=sa,
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
