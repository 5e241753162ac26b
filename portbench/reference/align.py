"""Plain scoring of alignments against the genome, NumPy only.

The configuration states the scoring (bwa-mem's defaults: match a,
mismatch -b, a base N against anything -1, a gap of length l costs
o + e l, insertions and deletions alike here); a clip costs nothing in
the alignment's own score. `cigar_score` scores an alignment as a
record states it; `truth_score` scores the path the simulation took (the
read's origin and its indel), which the best alignment of the read
scores at least.
"""

from __future__ import annotations

import numpy as np


def _match_score(q, r, sc):
    n = (q > 3) | (r > 3)
    eq = (q == r) & ~n
    return int(np.where(n, -1, np.where(eq, sc["a"], -sc["b"])).sum()), \
        int((~eq).sum())


def cigar_score(read, genome, pos, cigar, sc):
    """(score, NM, query length) of the alignment of `read` (forward
    strand, as a record stores it) at genome position `pos` with `cigar`;
    None when it leaves the genome. NM as bwa-mem counts it: mismatches,
    inserted bases, and deleted bases between two aligned operations.
    bwa's bwa_gen_cigar2 (bwa.c) leaves a deletion at either end of the
    alignment out of NM ("don't do the leading or trailing deletion"),
    and mem_reg2aln (bwamem.c) then squeezes a leading deletion out of
    the CIGAR or, where there is none, a trailing one (if ... else if):
    an alignment with a deletion at both ends keeps the trailing one in
    its record, uncounted in NM. A leading deletion never stays
    (`leading_deletion`)."""
    qi, ri, score, nm, qlen = 0, pos, 0, 0, 0
    core = [i for i, (op, _) in enumerate(cigar) if op not in "SH"]
    for i, (op, ln) in enumerate(cigar):
        if op in "M=X":
            if ri + ln > len(genome) or qi + ln > len(read) or ri < 0:
                return None
            s, mm = _match_score(read[qi:qi + ln], genome[ri:ri + ln], sc)
            score += s
            nm += mm
            qi += ln
            ri += ln
            qlen += ln
        elif op == "I":
            score -= sc["o_ins"] + sc["e_ins"] * ln
            nm += ln
            qi += ln
            qlen += ln
        elif op == "D":
            score -= sc["o_del"] + sc["e_del"] * ln
            nm += ln if core[0] < i < core[-1] else 0
            ri += ln
        elif op == "S":
            qi += ln
            qlen += ln
        elif op == "H":
            qlen += ln
        else:
            return None
    return score, nm, qlen


def leading_deletion(cigar) -> bool:
    """The first aligned operation is a deletion: bwa-mem squeezes it
    out of every record (mem_reg2aln), so a record that keeps one does
    not state bwa-mem's alignment."""
    core = [op for op, _ in cigar if op not in "SH"]
    return bool(core) and core[0] == "D"


def truth_cigar(L, indel, k, d):
    """The CIGAR of the path the simulation took."""
    if indel == 0:
        return [("M", L)]
    if indel < 0:
        return [("M", k), ("D", d), ("M", L - k)]
    return [("M", k), ("I", d), ("M", L - k - d)]


def truth_score(read, genome, pos, indel, k, d, sc):
    return cigar_score(read, genome, pos,
                       truth_cigar(len(read), indel, k, d), sc)[0]


def ref_span(cigar) -> int:
    return sum(ln for op, ln in cigar if op in "MDN=X")


def five_prime(rec) -> int:
    """The unclipped 5' end of a mapped record: the start less its
    leading clips on the forward strand, the end plus its trailing clips
    on the reverse."""
    lead = 0
    for op, ln in rec.cigar:
        if op not in "SH":
            break
        lead += ln
    tail = 0
    for op, ln in reversed(rec.cigar):
        if op not in "SH":
            break
        tail += ln
    if rec.flag & 0x10:
        return rec.pos + ref_span(rec.cigar) - 1 + tail
    return rec.pos - lead


def outer_tlen(rec, mate) -> int:
    """TLEN as bwa-mem writes it for two mapped ends on one reference:
    from this end's 5' end to the mate's, signed, counting both ends."""
    p0 = rec.pos + (ref_span(rec.cigar) - 1 if rec.flag & 0x10 else 0)
    p1 = mate.pos + (ref_span(mate.cigar) - 1 if mate.flag & 0x10 else 0)
    return -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))
