"""The control: the plain reference put in the port's place, with one
guarantee of the configuration broken, its output written as the port's
entry writes it and judged by the harness against the cell's limits.

The configuration states gapped alignment under affine gap costs. The
control aligns every read without gaps: at its true origin and strand
(which only the simulation knows), CIGAR L M, AS and NM of that ungapped
alignment. For single ends it writes a coordinate-sorted BAM with
duplicates flagged by the comparison's own rule, for pairs a SAM with
each end's mate fields; the harness reads it back (`reference.records`)
and judges it as it judges a run (`lib.harness.judge`). Every number but
the one that sees the broken guarantee reads as a sound run's would;
that one (misplaced_pct: a read with an indel scores below its true
path) has to fail its limit, so the control is not correct.

    python3 portbench/reference/control.py --workload <cell> \
        --reads <n> --seeds <a,b,c>

prints each seed's verdict and numbers. It needs no card and nothing of
the port.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import types


BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from lib import genome as genmod  # noqa: E402
from lib import harness  # noqa: E402
from lib import reads as readsmod  # noqa: E402
from reference import align, records  # noqa: E402


def gapless(reads, i, genome, sc, name, flag=0):
    """The ungapped record of read i at its origin."""
    codes = reads.codes[i]
    rev = bool(reads.rev[i])
    seq = (3 - codes[::-1]) if rev else codes
    L = len(codes)
    pos = int(reads.pos[i])
    score, nm, _ = align.cigar_score(seq, genome, pos, [("M", L)], sc)
    return records.Record(name, flag | (0x10 if rev else 0), 0, pos, 60,
                          [("M", L)], seq, -1, -1, 0, score, nm)


def single_end(reads, n, genome, sc):
    recs = [gapless(reads, i, genome, sc, reads.names[i]) for i in range(n)]
    groups = collections.defaultdict(list)
    for i, r in enumerate(recs):
        q = reads.quals[i]
        groups[(align.five_prime(r), bool(r.flag & 0x10))].append(
            (-int(q[q >= 15].sum()), i))
    for g in groups.values():
        for _, i in sorted(g)[1:]:
            recs[i].flag |= 0x400
    return sorted(recs, key=lambda r: r.pos)


def paired_end(ends, n_pairs, genome, sc):
    recs = []
    for i in range(n_pairs):
        pair = [gapless(ends[e], i, genome, sc, ends[e].names[i],
                        0x1 | (0x40 if e == 0 else 0x80)) for e in (0, 1)]
        for e in (0, 1):
            r, m = pair[e], pair[1 - e]
            r.rnext, r.pnext = m.ref, m.pos
            r.flag |= 0x20 if m.flag & 0x10 else 0
            r.tlen = align.outer_tlen(r, m)
        recs.extend(pair)
    return recs


def judged(cell_name, n_reads, seed, genome=None):
    """(correct, {number: (value, limit)}) of the control on `n_reads`
    reads of the cell's traffic drawn from `seed`, over the cell's
    configured genome unless one is given."""
    cell = harness.load_json("workloads", cell_name)
    config = harness.load_json("configs", cell["config"])
    mix = harness.load_json("mixes", cell["traffic"])
    sc = config["scoring"]
    if genome is None:
        genome = genmod.generate(config["genome_bp"], config["genome_seed"])
    refs = [config["contig"]], [len(genome)]
    ctx = types.SimpleNamespace(seed=seed, cell=cell, config=config)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        if mix["kind"] == "se":
            reads = readsmod.single_end(genome, n_reads, seed, 0, mix)
            run = types.SimpleNamespace(
                bam=os.path.join(tmp, "out.bam"), reads=reads,
                fed=n_reads, genome=genome)
            records.write_bam(run.bam, *refs,
                              single_end(reads, n_reads, genome, sc))
        elif mix["kind"] == "pe":
            n_pairs = n_reads // 2
            ends = readsmod.paired_end(genome, n_pairs, seed, 0, mix)
            run = types.SimpleNamespace(
                sam=os.path.join(tmp, "out.sam"), reads=ends,
                fed=2 * n_pairs, genome=genome)
            records.write_sam(run.sam, *refs,
                              paired_end(ends, n_pairs, genome, sc))
        else:
            raise harness.RunFailed(f"no control for traffic of kind "
                                    f"{mix['kind']!r}")
        return harness.judge(ctx, run)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--reads", type=int, required=True,
                    help="reads a window of the cell completes")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, table = judged(args.workload, args.reads, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reads": args.reads, "correct": correct,
                          "control": {k: v for k, (v, _) in
                                      table.items()}}), flush=True)


if __name__ == "__main__":
    main()
