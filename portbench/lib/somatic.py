"""A tumor/normal exome slice drawn from a run's --seed.

Targets: `targets` exon-like intervals of target_min-target_max bp, one
in each equal slot of the chromosome (so spread over all of it, sorted,
never overlapping) in sequence of some complexity, drawn once from the
mix's `target_seed`: the capture
design is the deployment's, the same in every run, which the caller
works through in order; only the variants and the reads come from the
run's seed. Reads: 150 bp reads captured over each target and
`flank` bases on either side, as scripts/mutect_campaign.py's
`sim_reads` makes them (aligned reads, CIGAR L M, 0.2% sequencing errors
at quality 32, MAPQ 60, a proper pair's fields), at `tumor_depth` and
`normal_depth` over the target. Variants: one somatic SNV in every
`somatic_every`-th target at a tumor allele fraction uniform in
[vaf_min, vaf_max] (absent from the normal), and germline heterozygous
SNPs at `germline_per_kb` per kb of target in both samples.

The bases are drawn for all targets in set-up; the read dicts that the
port's caller takes are built one target at a time, as the port's own
BAM source builds them one window at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .reads import rng_for


@dataclasses.dataclass
class Slice:
    starts: np.ndarray        # int64[T] target starts (0-based)
    ends: np.ndarray          # int64[T] target ends (exclusive)
    somatic: dict             # target -> (pos, alt, vaf)
    germline: list            # target -> [(pos, alt)]
    tumor: list               # target -> (starts int64[n], codes u8[n, L])
    normal: list
    L: int
    flank: int
    qual: int

    def window(self, t):
        """The span the caller looks at for target t."""
        return int(self.starts[t]) - self.flank, \
            int(self.ends[t]) + self.flank

    def read_dicts(self, t, sample: str, seed: int):
        """The target's reads of one sample, as the port's caller takes
        them (mutect_campaign.sim_reads' fields)."""
        starts, codes = (self.tumor if sample == "tumor" else
                         self.normal)[t]
        rng = np.random.default_rng([seed % (1 << 64), 3, t,
                                     sample == "tumor"])
        rev = rng.random(len(starts)) < 0.5
        qual = np.full(self.L, self.qual, np.int64)
        cig = [(0, self.L)]
        return [dict(rid=0, pos=int(s), cigar=cig,
                     seq_codes=codes[i].astype(np.int64), quals=qual,
                     mate_start=int(s) + 180, properly_paired=True,
                     flag=0x2 | (0x10 if rev[i] else 0), mapq=60,
                     is_reverse=False, frag_len=331)
                for i, s in enumerate(starts.tolist())]


def complexity(seq) -> float:
    """Distinct 6-mers over 6-mers in seq."""
    s = np.asarray(seq, np.int64)
    k = np.zeros(len(s) - 5, np.int64)
    for i in range(6):
        k = k * 4 + s[i:len(s) - 5 + i]
    return len(np.unique(k)) / len(k)


def targets(genome, mix, stream):
    """The capture design: fixed by the mix's target_seed (a deployment
    calls many samples on one exome kit), the same for every run. As
    capture probes are designed on repeat-masked sequence, a target and
    its flanks lie in sequence whose 6-mers are at least
    `min_complexity` distinct (the slot's next draw otherwise)."""
    rng = rng_for(mix["target_seed"], 2 + stream)
    G, T = len(genome), mix["targets"]
    L, flank = mix["read_len"], mix["flank"]
    slot = (G - 4 * flank - 2 * L) // T
    starts, ends = [], []
    for t in range(T):
        while True:
            n = int(rng.integers(mix["target_min"], mix["target_max"] + 1))
            s = 2 * flank + L + t * slot + \
                int(rng.random() * (slot - n - 2 * flank - L))
            if complexity(genome[s - flank:s + n + flank]) >= \
                    mix["min_complexity"]:
                break
        starts.append(s)
        ends.append(s + n)
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def draw(genome, seed, stream, mix, n_targets=None) -> Slice:
    """The slice of a run: the design's targets (stream 1: another
    design's, for the warm-up) with variants and reads drawn from the
    run's seed."""
    rng = rng_for(seed, stream)
    L, flank = mix["read_len"], mix["flank"]
    starts, ends = targets(genome, mix, stream)
    T = n_targets or len(starts)
    starts, ends = starts[:T], ends[:T]
    somatic, germline, tumor, normal = {}, [], [], []
    for t in range(T):
        s0, e0 = int(starts[t]), int(ends[t])
        n_g = rng.poisson(mix["germline_per_kb"] * (e0 - s0) / 1000)
        germ = [(int(p), (int(genome[p]) + int(rng.integers(1, 4))) % 4)
                for p in rng.integers(s0, e0, n_g)]
        germline.append(germ)
        if t % mix["somatic_every"] == 0:
            p = int(rng.integers(s0, e0))
            somatic[t] = (p, (int(genome[p]) + int(rng.integers(1, 4))) % 4,
                          float(rng.uniform(mix["vaf_min"], mix["vaf_max"])))
        for depth, out, som in ((mix["tumor_depth"], tumor, True),
                                (mix["normal_depth"], normal, False)):
            lo, hi = s0 - flank, e0 + flank - L
            n = int(round(depth * (hi - lo) / L))
            rs = np.sort(rng.integers(lo, hi + 1, n))
            codes = genome[rs[:, None] + np.arange(L)].copy()
            m = rng.random(codes.shape, dtype=np.float32) < mix["error_rate"]
            codes[m] = rng.integers(0, 4, int(m.sum()), dtype=np.uint8)
            for p, alt in germ:
                on = (rs <= p) & (p < rs + L) & (rng.random(n) < 0.5)
                codes[on, p - rs[on]] = alt
            if som and t in somatic:
                p, alt, vaf = somatic[t]
                on = (rs <= p) & (p < rs + L) & (rng.random(n) < vaf)
                codes[on, p - rs[on]] = alt
            out.append((rs.astype(np.int64), codes.astype(np.uint8)))
    return Slice(starts, ends, somatic, germline, tumor, normal, L, flank,
                 mix["qual"])
