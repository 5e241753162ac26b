"""The benchmark's generators: its genome is scripts/gen_genome.py's
draw, its reads repeat exactly for a seed, never repeat within a run,
and carry a truth that reproduces them."""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

import pb_common as pc

sys.path.insert(0, pc.BENCH)

from lib import genome, reads  # noqa: E402
from reference import align  # noqa: E402

SE = dict(kind="se", read_len=150, reads=600, sub_rate=0.01,
          indel_share=0.1, indel_max=3, dup_share=0.1, dup_gap=50,
          qual_min=25, qual_max=40)
PE = dict(kind="pe", read_len=150, reads=600, insert_mean=400,
          insert_sd=40, sub_rate=0.01, indel_share=0.1, indel_max=3,
          bait_share=0.05, qual_min=25, qual_max=40)
SC = dict(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1)


def test_genome_is_the_scripts_draw():
    spec = importlib.util.spec_from_file_location(
        "gen_genome", os.path.join(pc.REPO, "scripts", "gen_genome.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for n, seed in ((120_000, 0), (230_001, 7)):
        assert np.array_equal(genome.generate(n, seed),
                              mod.generate(n, seed))


def test_reads_repeat_for_a_seed():
    g = genome.generate(150_000, 1)
    big = 2 ** 31 + 11
    a = reads.single_end(g, 600, big, 0, SE)
    b = reads.single_end(g, 600, big, 0, SE)
    c = reads.single_end(g, 600, big + 1, 0, SE)
    w = reads.single_end(g, 600, big, 1, SE)
    assert np.array_equal(a.codes, b.codes) and a.names == b.names
    assert np.array_equal(a.quals, b.quals) and np.array_equal(a.pos, b.pos)
    assert not np.array_equal(a.codes, c.codes)
    assert not np.array_equal(a.codes, w.codes)
    p = reads.paired_end(g, 300, big, 0, PE)
    q = reads.paired_end(g, 300, big, 0, PE)
    assert all(np.array_equal(x.codes, y.codes) for x, y in zip(p[:2], q[:2]))
    assert np.array_equal(p[2], q[2])


def test_no_read_repeats_within_a_run():
    """Names are unique, and no read repeats (name, bases and
    qualities): a planted duplicate shares its source's origin and
    strand, with its own errors and qualities."""
    g = genome.generate(150_000, 1)
    r = reads.single_end(g, 5000, 5, 0, SE)
    assert len(set(r.names)) == len(r)
    keys = {(r.codes[i].tobytes(), r.quals[i].tobytes()) for i in
            range(len(r))}
    assert len(keys) == len(r)
    starts = {(int(p), bool(v)) for p, v in zip(r.pos, r.rev)}
    assert len(starts) < len(r) - 0.09 * len(r)


def test_truth_reproduces_the_reads():
    """Each read is its origin's bases through its indel with a few
    substitutions: scoring the true path counts exactly the indel and
    the substitutions, and a baited end every 12th base more."""
    g = genome.generate(150_000, 2)
    r = reads.single_end(g, 2000, 9, 0, SE)
    subs = []
    for i in range(len(r)):
        cig = align.truth_cigar(150, int(r.indel[i]), int(r.k[i]),
                                int(r.d[i]))
        score, nm, qlen = align.cigar_score(r.forward(i), g, int(r.pos[i]),
                                            cig, SC)
        assert qlen == 150
        gap = int(r.d[i])
        subs.append(nm - gap)
    subs = np.asarray(subs)
    assert 0.8 < subs.mean() / 1.5 < 1.2      # 1% of 150 bases
    assert abs((r.indel != 0).mean() - 0.1) < 0.03
    r1, r2, bait = reads.paired_end(g, 1000, 9, 0, PE)
    for e, ends in enumerate((r1, r2)):
        for i in range(0, 1000, 7):
            nm = align.cigar_score(ends.forward(i), g, int(ends.pos[i]),
                                   align.truth_cigar(150, int(ends.indel[i]),
                                                     int(ends.k[i]),
                                                     int(ends.d[i])), SC)[1]
            if bait[i] == e + 1:
                assert nm >= 10
    ins = np.abs(np.where(r1.rev, r1.pos, r2.pos) + 150
                 - np.where(r1.rev, r2.pos, r1.pos))
    assert abs(ins.mean() - 400) < 10 and np.all(r1.rev != r2.rev)
