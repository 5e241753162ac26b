"""The plain reference's comparison for read pairs through the port's
`mem -t` entry: the SAM, in input order.

Numbers (each at most its limit in the cell's file):
  missing          fed pairs without exactly one primary record of each
                   end, plus primary records of pairs never fed
  aln_inconsistent sampled ends whose primary record does not state the
                   read or whose NM differs from its alignment against
                   the genome (as for single ends), or whose mate
                   fields differ from the other end's record: with both
                   ends mapped, RNEXT and PNEXT its position, the mate
                   strand flag its strand, TLEN from 5' end to 5' end
                   (bwa-mem's rule; 0 across references); with the mate
                   unmapped, the mate-unmapped flag
  misplaced_pct    share (%) of the sampled ends mapped by an alignment
                   that scores below the path the simulation took
  unmapped_pct     share (%) of the sampled ends reported unmapped. A
                   baited end (every 12th base changed) is placed only by
                   mate rescue, so rescue's misses show here.
The sample is `sample` // 2 pairs drawn from the run's seed.
"""

from __future__ import annotations

import collections

from reference import align, records, se_bam


def judge(ctx, run):
    _, _, recs = records.read_sam(run.sam)
    return numbers(ctx, run.reads, run.fed, run.genome, recs)


def mate_ok(rec, mate) -> bool:
    if rec is None or mate is None:
        return False
    if not rec.flag & 0x1 or not rec.flag & (0x40 | 0x80):
        return False
    if rec.flag & 0x4 or mate.flag & 0x4:
        return rec.flag & 0x4 or bool(rec.flag & 0x8)
    tlen = align.outer_tlen(rec, mate) if rec.ref == mate.ref else 0
    return (not rec.flag & 0x8 and rec.rnext == mate.ref and
            rec.pnext == mate.pos and
            bool(rec.flag & 0x20) == bool(mate.flag & 0x10) and
            rec.tlen == tlen)


def numbers(ctx, reads, n_fed, genome, recs):
    sc = ctx.config["scoring"]
    ends = reads[:2]
    n_pairs = n_fed // 2
    names = ends[0].names[:n_pairs]
    fed = set(names)
    prim = collections.defaultdict(dict)
    extra = 0
    for r in recs:
        if r.flag & 0x900:
            continue
        e = 0 if r.flag & 0x40 else 1
        if e in prim[r.name]:
            extra += 1
        prim[r.name][e] = r
    missing = extra + sum(len(prim.get(nm, {})) != 2 for nm in names) + \
        sum(nm not in fed for nm in prim)
    bad = 0
    placed = collections.Counter()
    picked = se_bam.sample(ctx, n_pairs, ctx.cell["sample"] // 2)
    for i in picked:
        pr = prim.get(names[i], {})
        for e in (0, 1):
            rec, mate = pr.get(e), pr.get(1 - e)
            ok, where = se_bam.end_check(rec, ends[e], i, genome, sc)
            bad += not (ok and mate_ok(rec, mate))
            placed[where] += 1
    n = max(2 * len(picked), 1)
    return {"missing": missing, "aln_inconsistent": bad,
            "misplaced_pct": 100.0 * placed["below"] / n,
            "unmapped_pct": 100.0 * placed["unmapped"] / n}
