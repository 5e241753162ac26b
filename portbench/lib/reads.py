"""Read simulation from a run's --seed: the benchmark's own generator.

The error model is chip_smoke.py's `sim_reads`/`read_errors`/`sim_pairs`
/`bait` (and pipeline_scale's planted duplicates), drawn here in bulk
with numpy instead of one read at a time:
  * a read starts uniformly on the genome, on either strand;
  * one 1-3 base indel (insertion or deletion, equally likely) at an
    offset in [20, L - 20) in `indel_share` of the reads;
  * then `sub_rate` substitutions (each to one of the other three bases);
  * single-end: `dup_share` of the reads are duplicates of an earlier
    read of the stream (its origin, strand and indel; fresh substitutions
    and qualities), placed within `dup_gap` reads after it, as PCR
    duplicates arrive;
  * paired-end: fragments of normal length (insert_mean, insert_sd),
    either end first, the right end reverse complemented; in
    `bait_share` of the pairs one end has every 12th base changed, so
    that no exact run reaches the minimum seed length and only mate
    rescue can place it.

Every read carries its truth (origin, strand, indel), which the plain
reference reads back to score the true alignment. The same seed gives the
same reads; every seed gives the same number of reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LUT = np.frombuffer(b"ACGTN", np.uint8)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one stream (0: window, 1: warm-up)
    of a run's seed; any whole number is a seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


@dataclasses.dataclass
class Reads:
    """A batch of simulated reads as sequenced (reverse-strand reads
    already reverse complemented) and their truth."""
    names: list
    codes: np.ndarray      # uint8[n, L]
    quals: np.ndarray      # uint8[n, L] phred
    pos: np.ndarray        # int64[n] leftmost genome position (0-based)
    rev: np.ndarray        # bool[n] read is the reverse strand
    indel: np.ndarray      # int8[n] 0 none, 1 insertion, -1 deletion
    k: np.ndarray          # int64[n] indel offset (forward orientation)
    d: np.ndarray          # int64[n] indel length

    def __len__(self):
        return len(self.names)

    def forward(self, i) -> np.ndarray:
        """Read i on the genome's forward strand."""
        s = self.codes[i]
        return (3 - s)[::-1] if self.rev[i] else s


def _draw(rng, genome, pos, rev, indel, k, d, L, sub_rate):
    """The reads of the given origins: the genome's bases through the
    indel, then substitutions, then the reverse strand's complement."""
    dmax = int(d.max(initial=0))
    win = np.lib.stride_tricks.sliding_window_view(genome, L + dmax)
    base = win[pos]
    codes = base[:, :L].copy()
    j = np.arange(L)[None, :]
    rows = np.flatnonzero(indel)
    if len(rows):
        kk, dd, ins = k[rows, None], d[rows, None], indel[rows, None] == 1
        off = np.where(j < kk, j, np.where(ins, j - dd, j + dd))
        new = np.take_along_axis(base[rows], np.maximum(off, 0), axis=1)
        put = ins & (j >= kk) & (j < kk + dd)
        new[put] = rng.integers(0, 4, int(put.sum()), dtype=np.uint8)
        codes[rows] = new
    m = rng.random(codes.shape, dtype=np.float32) < sub_rate
    codes[m] = (codes[m] + rng.integers(1, 4, int(m.sum()),
                                        dtype=np.uint8)) % 4
    codes[rev] = (3 - codes[rev])[:, ::-1]
    return codes


def _indels(rng, n, L, share, dmax):
    has = rng.random(n) < share
    kind = np.where(rng.random(n) < 0.5, 1, -1)
    indel = np.where(has, kind, 0).astype(np.int8)
    k = rng.integers(20, L - 20, n)
    d = rng.integers(1, dmax + 1, n)
    return indel, np.where(has, k, 0), np.where(has, d, 0)


def single_end(genome, n, seed, stream, mix, prefix="s") -> Reads:
    rng = rng_for(seed, stream)
    L = mix["read_len"]
    n_dup = int(n * mix["dup_share"])
    n_src = n - n_dup
    G = len(genome)
    pos = rng.integers(0, G - L - 8, n_src)
    rev = rng.random(n_src) < 0.5
    indel, k, d = _indels(rng, n_src, L, mix["indel_share"], mix["indel_max"])
    # each duplicate follows its source within dup_gap reads
    src = rng.integers(0, n_src, n_dup)
    key = np.concatenate([np.arange(n_src, dtype=np.float64),
                          src + rng.integers(1, mix["dup_gap"] + 1, n_dup)
                          + 0.5])
    order = np.argsort(key, kind="stable")
    allsrc = np.concatenate([np.arange(n_src), src])[order]
    pos, rev, indel, k, d = (a[allsrc] for a in (pos, rev, indel, k, d))
    codes = _draw(rng, genome, pos, rev, indel, k, d, L, mix["sub_rate"])
    quals = rng.integers(mix["qual_min"], mix["qual_max"] + 1, (n, L),
                         dtype=np.uint8)
    return Reads(names(prefix, n), codes, quals, pos.astype(np.int64), rev, indel,
                 k.astype(np.int64), d.astype(np.int64))


def paired_end(genome, n_pairs, seed, stream, mix, prefix="p"):
    """(Reads of the first ends, Reads of the second ends, baited end
    per pair: 0 none, 1 or 2)."""
    rng = rng_for(seed, stream)
    L = mix["read_len"]
    G = len(genome)
    ins = np.maximum(rng.normal(mix["insert_mean"], mix["insert_sd"],
                                n_pairs).astype(np.int64), L)
    p = (rng.random(n_pairs) * (G - ins - 8)).astype(np.int64)
    q = p + ins - L
    swap = rng.random(n_pairs) < 0.5
    ends = []
    for first in (True, False):
        left = first != swap          # this end is the fragment's left
        pos = np.where(left, p, q)
        rev = ~left
        indel, k, d = _indels(rng, n_pairs, L, mix["indel_share"],
                              mix["indel_max"])
        codes = _draw(rng, genome, pos, rev, indel, k, d, L,
                      mix["sub_rate"])
        quals = rng.integers(mix["qual_min"], mix["qual_max"] + 1,
                             (n_pairs, L), dtype=np.uint8)
        ends.append(Reads(names(prefix, n_pairs), codes,
                          quals, pos, rev, indel, k.astype(np.int64),
                          d.astype(np.int64)))
    bait = np.where(rng.random(n_pairs) < mix["bait_share"],
                    rng.integers(1, 3, n_pairs), 0)
    for b in (1, 2):
        rows = np.flatnonzero(bait == b)
        c = ends[b - 1].codes
        c[rows, ::12] = (c[rows, ::12] + 1) % 4
    return ends[0], ends[1], bait


def names(prefix: str, n: int) -> list:
    """Read names of one width: prefix and a zero-padded index."""
    w = len(str(max(n - 1, 0)))
    return [f"{prefix}{i:0{w}d}" for i in range(n)]


def write_fastq(path, reads: Reads, chunk=65536):
    """FASTQ of the reads, as a sequencer writes them (records built in
    bulk: the names have one width)."""
    n, L = reads.codes.shape
    if n == 0:
        open(path, "wb").close()
        return
    w = len(reads.names[0])
    rec = 1 + w + 1 + L + 3 + L + 1
    with open(path, "wb") as f:
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            buf = np.empty((c1 - c0, rec), np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1:1 + w] = np.frombuffer(
                "".join(reads.names[c0:c1]).encode(), np.uint8).reshape(-1, w)
            o = 1 + w
            buf[:, o] = ord("\n")
            buf[:, o + 1:o + 1 + L] = LUT[reads.codes[c0:c1]]
            o += 1 + L
            buf[:, o:o + 3] = np.frombuffer(b"\n+\n", np.uint8)
            buf[:, o + 3:o + 3 + L] = reads.quals[c0:c1] + 33
            buf[:, -1] = ord("\n")
            f.write(buf.tobytes())
