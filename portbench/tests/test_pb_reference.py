"""The plain reference on inputs worked by hand: its BAM and SAM
readers, the scoring, the 5' ends and TLEN, each number of the
comparisons, and the control, which has to fail a limit of each cell."""

from __future__ import annotations

import gzip
import json
import os
import struct
import sys
import types

import numpy as np
import pytest

import pb_common as pc

sys.path.insert(0, pc.BENCH)

from lib import genome, reads  # noqa: E402
from reference import align, control, pe_sam, records, se_bam  # noqa: E402

SC = dict(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1, pen_clip5=5,
          pen_clip3=5)


def _bam_record(name, flag, ref, pos, cigar, seq, tags):
    code = {c: i for i, c in enumerate("MIDNSHP=X")}
    nm = name.encode() + b"\0"
    cig = b"".join(struct.pack("<I", n << 4 | code[op]) for op, n in cigar)
    s = np.asarray(seq)
    nib = np.array([1, 2, 4, 8, 15], np.uint8)[s]
    if len(nib) % 2:
        nib = np.append(nib, 0)
    packed = (nib[0::2] << 4 | nib[1::2]).astype(np.uint8).tobytes()
    aux = b"".join(t.encode() + b"i" + struct.pack("<i", v)
                   for t, v in tags.items())
    body = struct.pack("<iiBBHHHiiii", ref, pos, len(nm), 60, 0,
                       len(cigar), flag, len(seq), -1, -1, 0) + nm + cig \
        + packed + bytes([30] * len(seq)) + aux
    return struct.pack("<i", len(body)) + body


def test_bam_and_sam_readers(tmp_path):
    seq = [0, 1, 2, 3, 0, 1, 4]
    head = b"BAM\1" + struct.pack("<i", 0) + struct.pack("<i", 1) + \
        struct.pack("<i", 4) + b"chr\0" + struct.pack("<i", 1000)
    data = head + _bam_record("r1", 16, 0, 99, [("S", 2), ("M", 5)], seq,
                              {"AS": 5, "NM": 0})
    p = tmp_path / "x.bam"
    p.write_bytes(gzip.compress(data[:30]) + gzip.compress(data[30:]))
    names, lens, t = records.read_bam(str(p))
    assert names == ["chr"] and lens == [1000] and len(t.names) == 1
    assert (t.lead.tolist(), t.tail.tolist(), t.span.tolist()) == \
        ([2], [0], [5])
    r = t.record(0)
    assert (r.name, r.flag, r.ref, r.pos, r.cigar, r.AS, r.NM) == \
        ("r1", 16, 0, 99, [("S", 2), ("M", 5)], 5, 0)
    assert r.seq.tolist() == seq
    s = tmp_path / "x.sam"
    s.write_text("@SQ\tSN:chr\tLN:1000\n"
                 "p1\t99\tchr\t100\t60\t3S147M\t=\t400\t451\tACGN\t*\t"
                 "NM:i:2\tAS:i:140\tXS:i:0\tRG:Z:a\n")
    _, _, recs = records.read_sam(str(s))
    r = recs[0]
    assert (r.pos, r.rnext, r.pnext, r.tlen, r.AS, r.NM) == \
        (99, 0, 399, 451, 140, 2)
    assert r.cigar == [("S", 3), ("M", 147)] and r.seq.tolist() == \
        [0, 1, 2, 4]


def test_scoring_by_hand():
    g = np.array([0, 1, 2, 3] * 10, np.uint8)
    read = g[4:14].copy()
    assert align.cigar_score(read, g, 4, [("M", 10)], SC) == (10, 0, 10)
    read[3] = 0                           # one mismatch: 9 - 4
    assert align.cigar_score(read, g, 4, [("M", 10)], SC) == (5, 1, 10)
    read[5] = 4                           # and an N: 8 - 4 - 1
    assert align.cigar_score(read, g, 4, [("M", 10)], SC) == (3, 2, 10)
    # 4 matches, a 2-base deletion (6 + 2), 6 matches
    q = np.concatenate([g[0:4], g[6:12]])
    assert align.cigar_score(q, g, 0, [("M", 4), ("D", 2), ("M", 6)],
                             SC) == (2, 2, 10)
    assert align.truth_score(q, g, 0, -1, 4, 2, SC) == 2
    # a deletion at the alignment's end costs its score but not NM (bwa)
    assert align.cigar_score(g[0:10], g, 0, [("M", 10), ("D", 2)],
                             SC) == (2, 0, 10)
    assert not align.leading_deletion([("M", 10), ("D", 2), ("S", 3)])
    assert align.leading_deletion([("S", 3), ("D", 2), ("M", 10)])
    # clips cost nothing in the alignment's own score
    assert align.cigar_score(g[0:10], g, 2, [("S", 2), ("M", 8)],
                             SC) == (8, 0, 10)
    assert align.cigar_score(g[0:10], g, 38, [("M", 10)], SC) is None


def test_five_prime_and_tlen_by_hand():
    R = lambda flag, pos, cig: records.Record("x", flag, 0, pos, 60, cig,
                                              None, 0, 0, 0, 0, 0)
    fwd = R(0, 100, [("S", 3), ("M", 50), ("I", 2), ("M", 95)])
    rev = R(16, 400, [("M", 140), ("D", 1), ("M", 5), ("S", 5)])
    assert align.five_prime(fwd) == 97
    assert align.five_prime(rev) == 400 + 146 - 1 + 5
    # bwa-mem: 5' to 5', both ends counted
    assert align.outer_tlen(fwd, rev) == 545 - 100 + 1
    assert align.outer_tlen(rev, fwd) == -(545 - 100 + 1)


def _ctx(seed=1, sample=10**6):
    return types.SimpleNamespace(seed=seed, cell={"sample": sample},
                                 config={"scoring": SC})


def test_each_number_sees_its_fault():
    g = genome.generate(150_000, 3)
    mix = json.load(open(os.path.join(pc.BENCH, "mixes",
                                      "se150_dup10.json")))
    mix["dup_gap"] = 20
    r = reads.single_end(g, 300, 4, 0, mix)
    good = control.single_end(r, 300, g, SC)
    T = records.Table.of
    base = se_bam.numbers(_ctx(), r, 300, g, T(good))
    assert base["missing"] == base["unsorted"] == base["dup_wrong"] == \
        base["aln_inconsistent"] == base["unmapped_pct"] == 0
    recs = [x for i, x in enumerate(good) if i % 2]     # half left out
    assert se_bam.numbers(_ctx(), r, 300, g, T(recs))["missing"] == 150
    recs = good[::-1]                                   # not sorted
    assert se_bam.numbers(_ctx(), r, 300, g, T(recs))["unsorted"] > 0
    recs = [records.Record(**{**vars(x), "flag": x.flag & ~0x400})
            for x in good]                               # no dup flags
    assert se_bam.numbers(_ctx(), r, 300, g, T(recs))["dup_wrong"] > 0
    recs = [records.Record(**{**vars(x), "pos": x.pos + 1}) if i == 7
            else x for i, x in enumerate(good)]          # an answer moved
    assert se_bam.numbers(_ctx(), r, 300, g,
                          T(recs))["aln_inconsistent"] == 1
    recs = [records.Record(**{**vars(x), "pos": x.pos - 1,
                              "cigar": [("D", 1)] + x.cigar})
            if i == 9 else x for i, x in enumerate(good)]
    # the same bases aligned, but a leading deletion bwa-mem squeezes out
    assert se_bam.numbers(_ctx(), r, 300, g,
                          T(recs))["aln_inconsistent"] == 1


def _alignment_cells():
    """Every cell whose traffic is reads (single ends or pairs)."""
    out = []
    for f in sorted(os.listdir(os.path.join(pc.BENCH, "workloads"))):
        w = json.load(open(os.path.join(pc.BENCH, "workloads", f)))
        mix = json.load(open(os.path.join(pc.BENCH, "mixes",
                                          w["traffic"] + ".json")))
        if mix["kind"] in ("se", "pe"):
            out.append(w["name"])
    return out


def test_control_covers_every_listed_alignment_cell():
    b = json.load(open(os.path.join(pc.REPO, "BENCHMARK.json")))
    listed = {w["name"] for w in b["workloads"]}
    for name in listed:
        w = json.load(open(os.path.join(pc.BENCH, "workloads",
                                        name + ".json")))
        if set(w["checks"]) & {"se_bam", "pe_sam"}:
            assert name in _alignment_cells()


@pytest.mark.parametrize("cell", _alignment_cells())
def test_control_fails_each_cell(cell):
    """The control (gapless alignment at the origin), written as the
    cell's entry writes its output and judged by the harness with the
    cell's limits, is not correct: it reads above the limit on
    misplaced_pct and within every other limit."""
    g = genome.generate(300_000, 5)
    correct, table = control.judged(cell, 4000, 11, genome=g)
    assert not correct
    assert all(v <= lim for k, (v, lim) in table.items()
               if k != "misplaced_pct")
    v, lim = table["misplaced_pct"]
    assert v > lim + 1.0


def test_pairhmm_by_hand():
    """One read base against one haplotype base: the first row's Y
    (2^1020 / hlen) through tGM into M, times the match prior."""
    from reference import pairhmm
    one = lambda v: np.array([[v]])
    got = pairhmm.forward(one(0), [1], one(30), one(45), one(45), one(10),
                          one(0), [1])
    assert abs(got[0] - np.log10(0.999 * 0.9)) < 1e-12
    got = pairhmm.forward(one(0), [1], one(30), one(45), one(45), one(10),
                          one(2), [1])             # a mismatch: e / 3
    assert abs(got[0] - np.log10(1e-3 / 3 * 0.9)) < 1e-12
    assert pairhmm.bf16(1 + 2 ** -8) == 1.0            # a tie, to even
    assert pairhmm.bf16(1 + 3 * 2 ** -8) == 1 + 2 ** -6
    assert pairhmm.bf16(1 + 2 ** -7) == 1 + 2 ** -7


def test_pairhmm_control_fails_the_limit():
    """The reference in bfloat16 in the program's place reads a gap far
    above the somatic cell's limit on pairs like the caller's."""
    from reference import pairhmm, somatic
    w = json.load(open(os.path.join(pc.BENCH, "workloads",
                                    "chr20-somatic.json")))
    rng = np.random.default_rng(1)
    NP, R, H = 48, 150, 320
    hap = rng.integers(0, 4, (NP, H))
    rl = np.full(NP, R)
    hl = rng.integers(200, H + 1, NP)
    reads = np.stack([hap[p, 20:20 + R] for p in range(NP)])
    m = rng.random(reads.shape) < 0.01
    reads[m] = (reads[m] + 1) % 4
    q = np.full((NP, R), 32)
    iq, dq, cq = (np.full((NP, R), 45), np.full((NP, R), 45),
                  np.full((NP, R), 10))
    pairs = [reads, rl, q, iq, dq, cq, hap, hl, None]
    gap = somatic.hmm_gap(pairs, bf16=True)
    assert gap > 3 * w["limits"]["hmm_max_abs_log10"]
    pairs[8] = pairhmm.forward(*pairs[:8])
    assert somatic.hmm_gap(pairs) == 0.0


def test_roofline_by_hand():
    """P3's roofline share on the kernels line's shape (NP 2,048, R 151,
    H 384) at PR 15's 0.2593 ms: 2,048 x 151 x 384 = 118,751,232 cells x
    11 = 1.30626e9 FLOP, 19.4965 us at 67 TFLOP/s: 7.519%."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "roof", os.path.join(pc.BENCH, "metrics",
                             "kernels.pairhmm_roofline.py"))
    roof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roof)
    t = types.SimpleNamespace(counters={"hmm_cells": 2048 * 151 * 384},
                              kernel_ms={"pairhmm": 0.2593},
                              kernel_launches={"pairhmm": 1})
    assert abs(roof.least_seconds(118_751_232) - 19.4965e-6) < 1e-9
    assert abs(roof.read(t) - 7.519) < 1e-3
    t.kernel_launches = {"pairhmm": 0}
    assert roof.read(t) is None


def test_somatic_slice():
    from lib import somatic
    g = genome.generate(400_000, 4)
    mix = json.load(open(os.path.join(pc.BENCH, "mixes",
                                      "tn_exome100x50.json")))
    mix["targets"] = 20
    a = somatic.draw(g, 2 ** 31 + 3, 0, mix, n_targets=20)
    b = somatic.draw(g, 2 ** 31 + 3, 0, mix, n_targets=20)
    assert np.array_equal(a.starts, b.starts) and a.somatic == b.somatic
    c = somatic.draw(g, 5, 0, mix, n_targets=20)
    assert np.array_equal(a.starts, c.starts) and a.somatic != c.somatic
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a.tumor, b.tumor))
    assert np.all(a.ends[:-1] + 2 * a.flank < a.starts[1:])
    assert set(a.somatic) == set(range(0, 20, 2))
    for t in range(20):
        starts, codes = a.tumor[t]
        lo, hi = a.window(t)
        assert starts.min() >= lo and starts.max() + 150 <= hi
        depth = len(starts) * 150 / (hi - lo - 150)
        assert 90 < depth < 110
        p, alt, vaf = a.somatic.get(t, (None, None, None))
        if p is not None:
            cover = (starts <= p) & (p < starts + 150)
            frac = (codes[cover, p - starts[cover]] == alt).mean()
            assert abs(frac - vaf) < 0.25
    d = a.read_dicts(3, "normal", 7)
    assert d[0]["seq_codes"].dtype == np.int64 and d[0]["mapq"] == 60
