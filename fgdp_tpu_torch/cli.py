"""Command-line interface of the port: the aligner's two entry points.

  python -m fgdp_tpu_torch index <ref.fa> <out_prefix>    (bwa-mem2 index)
  python -m fgdp_tpu_torch mem   <prefix> <reads.fq> ...  (bwa-mem2 mem,
                                                           single-end)

`mem` runs on the CUDA card; --device cpu runs it on the CPU. Index
files use the JAX package's .npz formats (<prefix>.ref, .fmi, .lcp), so
either package reads the other's index.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def cmd_index(args):
    from .index.fmindex import FMIndex
    from .index.lcptree import LcpTree
    from .index.reference import PackedReference
    from .utils import dna

    t0 = time.time()
    pref = PackedReference.from_fasta(args.ref)
    pref.save(args.prefix + ".ref")
    print(f"[index] packed {len(pref.names)} contigs, "
          f"{pref.l_pac} bp in {time.time()-t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    fm = FMIndex.build(pref.codes)
    fm.save(args.prefix + ".fmi")
    print(f"[index] FM-index built in {time.time()-t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
    x = np.concatenate([pref.codes, dna.revcomp(pref.codes)])
    LcpTree.build(x.astype(np.uint8), fm.sa).save(args.prefix + ".lcp")
    print(f"[index] LCP-interval tree built in {time.time()-t0:.1f}s",
          file=sys.stderr)


def _mem_opt(args):
    """mem_opt_t from CLI flags incl. -x read-type profiles
    (reference src/fastmap.cpp:656-860): explicit flags win over the
    profile, matching the opt0-tracking update rules."""
    import dataclasses

    from .config import AlignConfig

    explicit = {k: v for k, v in dict(
        min_seed_len=args.k, w=args.w, a=args.A, b=args.B,
        T=args.T, zdrop=args.d, split_factor=args.r, max_occ=args.c,
        max_mem_intv=args.y, drop_ratio=args.D, max_matesw=args.m,
        pen_unpaired=args.U, chunk_size=args.K,
        max_XA_hits=getattr(args, "h0", None),
    ).items() if v is not None}
    if args.O is not None:
        explicit["o_del"] = explicit["o_ins"] = args.O
    if args.E is not None:
        explicit["e_del"] = explicit["e_ins"] = args.E
    if args.L is not None:
        explicit["pen_clip5"] = explicit["pen_clip3"] = args.L
    prof = {}
    if args.read_type:
        if args.read_type == "intractg":
            prof = dict(o_del=16, o_ins=16, b=9, pen_clip5=5, pen_clip3=5)
        elif args.read_type in ("pacbio", "pbref", "ont2d"):
            prof = dict(o_del=1, e_del=1, o_ins=1, e_ins=1, b=1,
                        split_factor=10.0, pen_clip5=0, pen_clip3=0,
                        min_chain_weight=20 if args.read_type == "ont2d"
                        else 40,
                        min_seed_len=14 if args.read_type == "ont2d"
                        else 17)
        else:
            raise SystemExit(f"unknown read type '{args.read_type}'")
    prof.update(explicit)          # explicit flags win (opt0 semantics)
    prof["output_all"] = bool(args.all_alignments)
    return dataclasses.replace(AlignConfig(), **prof)


def load_aligner(prefix, batch, opt=None, device=None):
    import os

    from .config import BatchShapes
    from .index.fmindex import FMIndex
    from .index.lcptree import LcpTree
    from .index.reference import PackedReference
    from .pipeline import Aligner

    pref = PackedReference.load(prefix + ".ref")
    fm = FMIndex.load(prefix + ".fmi")
    lcp = None                      # build in-process if not on disk
    if os.path.exists(prefix + ".lcp.npz"):
        lcp = LcpTree.load(prefix + ".lcp.npz")
        if lcp.isa is None:         # pre-isa artifact: rebuild
            lcp = None
    return Aligner(pref, fm, opt=opt, shapes=BatchShapes(batch_reads=batch),
                   lcp=lcp, device=device)


def read_batches(paths, batch):
    from .io.fastq import parse_fastq_records
    from .utils import dna

    it = parse_fastq_records(paths[0])
    while True:
        names, seqs, quals = [], [], []
        for _ in range(batch):
            r = next(it, None)
            if r is None:
                break
            names.append(r[0])
            seqs.append(dna.encode(r[2]).astype(np.int64))
            quals.append(r[3].decode() if r[3] else None)
        if not names:
            return
        yield names, seqs, quals


def _timed_batches(paths, batch):
    from .utils.profiling import PROF, READ_IO

    it = read_batches(paths, batch)
    while True:
        with PROF.phase(READ_IO):
            b = next(it, None)
        if b is None:
            return
        yield b


def cmd_mem(args):
    from .pipeline_stream import stream_mem
    from .utils.profiling import PROF, SAM_IO

    if len(args.reads) != 1:
        raise SystemExit("mem: the port aligns single-end reads only "
                         "(one FASTQ)")
    aligner = load_aligner(args.prefix, args.batch, opt=_mem_opt(args),
                           device=args.device)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for ln in aligner.sam_header(rg_line=args.rg):
            out.write(ln + "\n")
        t0 = time.time()

        def write_line(ln):
            with PROF.phase(SAM_IO):
                out.write(ln + "\n")

        def progress(n):
            dt = max(time.time() - t0, 1e-9)
            print(f"[mem] {n} reads, {n/dt:.0f} reads/s", file=sys.stderr)

        n = stream_mem(aligner, _timed_batches(args.reads, args.batch),
                       write_line, progress=progress)
    finally:
        if args.output:
            out.close()
    PROF.display_stats(units=n, unit_name="reads")


def main(argv=None):
    p = argparse.ArgumentParser(prog="fgdp-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index")
    pi.add_argument("ref")
    pi.add_argument("prefix")
    pi.set_defaults(fn=cmd_index)

    pm = sub.add_parser("mem")
    pm.add_argument("prefix")
    pm.add_argument("reads", nargs="+")
    pm.add_argument("-o", "--output")
    pm.add_argument("-b", "--batch", type=int, default=512)
    pm.add_argument("--device", default=None,
                    help="torch device [cuda]; 'cpu' runs on the CPU")
    pm.add_argument("-a", dest="all_alignments", action="store_true",
                    help="output all alignments (MEM_F_ALL)")
    # mem_opt_t flags (reference fastmap.cpp:656-799); None = default
    pm.add_argument("-k", type=int, help="min seed length [19]")
    pm.add_argument("-w", type=int, help="band width [100]")
    pm.add_argument("-A", type=int, help="match score [1]")
    pm.add_argument("-B", type=int, help="mismatch penalty [4]")
    pm.add_argument("-O", type=int, help="gap open penalty [6]")
    pm.add_argument("-E", type=int, help="gap extension penalty [1]")
    pm.add_argument("-L", type=int, help="clipping penalty [5]")
    pm.add_argument("-T", type=int, help="min output score [30]")
    pm.add_argument("-d", type=int, help="Z-dropoff [100]")
    pm.add_argument("-r", type=float, help="re-seed split factor [1.5]")
    pm.add_argument("-c", type=int, help="max seed occurrences [500]")
    pm.add_argument("-y", type=int, help="K3 seed-strategy cap [20]")
    pm.add_argument("-D", type=float, help="chain drop ratio [0.5]")
    pm.add_argument("-m", type=int, help="mate-rescue rounds [50]")
    pm.add_argument("-U", type=int, help="unpaired penalty [17]")
    pm.add_argument("-K", type=int, help="chunk size in bp [10000000]")
    pm.add_argument("-H", dest="h0", type=int,
                    help="max XA hits [5] (reference -h)")
    pm.add_argument("-x", dest="read_type",
                    help="read type: pacbio/ont2d/intractg")
    pm.add_argument("-R", dest="rg", help="read group header line")
    pm.set_defaults(fn=cmd_mem)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
