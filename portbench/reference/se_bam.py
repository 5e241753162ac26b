"""The plain reference's comparison for single-end reads through the
port's `pipeline` entry: the coordinate-sorted, duplicate-marked BAM.

Numbers (each at most its limit in the cell's file):
  missing          fed reads without exactly one primary record, plus
                   primary records of reads never fed
  unsorted         records before their predecessor in coordinate order
                   (unmapped records last)
  dup_wrong        groups of primary mapped records that share reference,
                   unclipped 5' end and strand whose duplicate flags are
                   not: all but one flagged, the one kept of the best
                   score (sum of base qualities of 15 or more)
  aln_inconsistent sampled reads whose primary record does not state the
                   read (SEQ, strand by strand; the query length of its
                   CIGAR), whose NM differs from the edit distance of
                   the alignment it states, against the genome, or whose
                   CIGAR keeps a leading deletion (reference.align)
  misplaced_pct    share (%) of the sampled reads mapped by an alignment
                   that, scored against the genome, scores below the path
                   the simulation took: placed worse than at the origin
  unmapped_pct     share (%) of the sampled reads reported unmapped (the
                   port reports a read unmapped when its escalation
                   ladder's last rung leaves it overflowed with no
                   region)
The sample is `sample` reads drawn from the run's seed among those fed.
A record's AS is not compared: it is bwa-mem's best local score of the
extension, which the alignment the record states need not reach.
"""

from __future__ import annotations

import collections

import numpy as np

from reference import align, records


def sample(ctx, n, k):
    """k of range(n), drawn from the run's seed."""
    rng = np.random.default_rng([int(ctx.seed) % (1 << 64), 7])
    return np.sort(rng.choice(n, min(k, n), replace=False))


def judge(ctx, run):
    _, _, table = records.read_bam(run.bam)
    return numbers(ctx, run.reads, run.fed, run.genome, table)


def unsorted(t) -> int:
    """Records before their predecessor in (reference, position) order,
    records without a reference last."""
    ref = np.where(t.ref >= 0, t.ref, np.iinfo(np.int64).max)
    back = (ref[1:] < ref[:-1]) | ((ref[1:] == ref[:-1]) &
                                   (t.pos[1:] < t.pos[:-1]))
    return int(back.sum())


def primaries(t):
    """({read name: index of its primary record}, primary records beyond
    one a name)."""
    js = np.flatnonzero((t.flag & 0x900) == 0)
    names = [t.names[j] for j in js.tolist()]
    prim = dict(zip(names, js.tolist()))
    return prim, len(names) - len(prim)


def missing(names, prim, extra) -> int:
    fed = set(names)
    return extra + sum(nm not in prim for nm in names) + \
        sum(nm not in fed for nm in prim)


def dup_wrong(reads, index, prim, t) -> int:
    """Groups of primary mapped records sharing reference, unclipped 5'
    end and strand whose flags are not all-but-one duplicate with the
    best-scoring record kept."""
    rows = [(j, index[nm]) for nm, j in prim.items()
            if nm in index and not t.flag[j] & 0x4]
    if not rows:
        return 0
    j, i = (np.asarray(x, np.int64) for x in zip(*rows))
    q = reads.quals[i].astype(np.int64)
    score = (q * (q >= 15)).sum(axis=1)
    rev = (t.flag[j] & 0x10) != 0
    p5 = np.where(rev, t.pos[j] + t.span[j] - 1 + t.tail[j],
                  t.pos[j] - t.lead[j])
    ref = t.ref[j]
    order = np.lexsort((rev, p5, ref))
    key = np.stack([ref[order], p5[order], rev[order]], axis=1)
    new = np.ones(len(order), bool)
    new[1:] = (key[1:] != key[:-1]).any(axis=1)
    starts = np.flatnonzero(new)
    dup = (t.flag[j][order] & 0x400) != 0
    sc = score[order]
    kept = np.add.reduceat((~dup).astype(np.int64), starts)
    best = np.maximum.reduceat(sc, starts)
    kept_score = np.maximum.reduceat(np.where(dup, -1, sc), starts)
    return int(((kept != 1) | (kept_score < best)).sum())


def end_check(rec, reads, i, genome, sc):
    """(consistent, placement) of the primary record of read i:
    placement is "unmapped", "below" (mapped, but its alignment scores
    below the path the simulation took) or "placed"."""
    codes = reads.codes[i]
    if rec is None:
        return False, "unmapped"
    expect = (3 - codes[::-1]) if rec.flag & 0x10 else codes
    if rec.flag & 0x4:
        return np.array_equal(rec.seq, expect), "unmapped"
    cs = align.cigar_score(expect, genome, rec.pos, rec.cigar, sc) \
        if np.array_equal(rec.seq, expect) and rec.ref == 0 else None
    if cs is None:
        return False, "below"
    score, nm, qlen = cs
    consistent = qlen == len(codes) and nm == rec.NM and \
        not align.leading_deletion(rec.cigar)
    truth = align.truth_score(reads.forward(i), genome, int(reads.pos[i]),
                              int(reads.indel[i]), int(reads.k[i]),
                              int(reads.d[i]), sc)
    return consistent, "below" if score < truth else "placed"


def numbers(ctx, reads, n_fed, genome, t):
    """The numbers of a run's records (a records.Table)."""
    sc = ctx.config["scoring"]
    names = reads.names[:n_fed]
    index = {nm: i for i, nm in enumerate(names)}
    prim, extra = primaries(t)
    bad = 0
    placed = collections.Counter()
    picked = sample(ctx, n_fed, ctx.cell["sample"])
    for i in picked:
        j = prim.get(names[i])
        ok, where = end_check(None if j is None else t.record(j), reads,
                              i, genome, sc)
        bad += not ok
        placed[where] += 1
    n = max(len(picked), 1)
    return {"missing": missing(names, prim, extra), "unsorted": unsorted(t),
            "dup_wrong": dup_wrong(reads, index, prim, t),
            "aln_inconsistent": bad,
            "misplaced_pct": 100.0 * placed["below"] / n,
            "unmapped_pct": 100.0 * placed["unmapped"] / n}
