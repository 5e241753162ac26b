"""Command-line interface of the port.

  python -m fgdp_tpu_torch index  <ref.fa> <out_prefix>   (bwa-mem2 index)
  python -m fgdp_tpu_torch mem    <prefix> <r1.fq> [r2.fq] (bwa-mem2 mem;
                                                          two FASTQs:
                                                          paired-end)
  python -m fgdp_tpu_torch sormadup <in.sam> <out.bam>    (sormadup)
  python -m fgdp_tpu_torch mutect -R ref.fa -I tumor.bam [-N normal.bam]
                                  -O out.vcf              (Mutect2 +
                                                          FilterMutectCalls)
  python -m fgdp_tpu_torch pipeline <prefix> <r1.fq> [r2.fq] -O out.bam
                                  [-t N] [--vcf out.vcf -R ref.fa
                                  [-N normal.bam]]        (all three,
                                                          stages overlapped)

`mem`, `sormadup`, `mutect` and `pipeline` run on the CUDA card;
--device cpu runs them on the CPU. Index files use the JAX package's
.npz formats (<prefix>.ref, .fmi, .rmi, .lcp), so either package reads the
other's index.
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
    from .index.rmi import RMIndex
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
    RMIndex.build(x, fm.sa).save(args.prefix + ".rmi")
    print(f"[index] RMI learned index built in {time.time()-t0:.1f}s",
          file=sys.stderr)
    t0 = time.time()
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
    lcp = True                      # build in-process if not on disk
    if os.path.exists(prefix + ".lcp.npz"):
        lcp = LcpTree.load(prefix + ".lcp.npz")
        if lcp.isa is None:         # pre-isa artifact: rebuild
            lcp = True
    return Aligner(pref, fm, opt=opt, shapes=BatchShapes(batch_reads=batch),
                   lcp=lcp, device=device)


def read_batches(paths, batch):
    """(names, seqs, quals) batches of `batch` reads from one FASTQ, or
    of batch // 2 pairs from two, interleaved [r1_0, r2_0, r1_1, ...]: a
    batch never splits a pair (the insert-size stats are per batch)."""
    from .io.fastq import parse_fastq_records
    from .utils import dna

    if len(paths) not in (1, 2):
        raise SystemExit(f"expected one FASTQ (single-end) or two "
                         f"(paired-end), got {len(paths)}")
    its = [parse_fastq_records(p) for p in paths]
    while True:
        names, seqs, quals = [], [], []
        for _ in range(batch // len(its)):
            recs = [next(it, None) for it in its]
            if recs[0] is None:
                break
            for r in recs:
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

        batches = _timed_batches(args.reads, args.batch)
        paired = len(args.reads) == 2
        if args.finalize_workers > 0:
            from .pipeline_stream import stream_mem_pooled
            pool = _finalize_pool(args, aligner, paired)
            try:
                n = stream_mem_pooled(aligner, batches, write_line, pool,
                                      paired=paired, progress=progress)
            finally:
                pool.shutdown()
        else:
            n = stream_mem(aligner, batches, write_line, paired=paired,
                           progress=progress)
    finally:
        if args.output:
            out.close()
    PROF.display_stats(units=n, unit_name="reads")


def _finalize_pool(args, aligner, paired):
    """The -t worker pool; a paired-end pool rescues mates on the
    aligner's device."""
    from .pipeline_stream import FinalizePool
    return FinalizePool(args.prefix + ".ref", aligner.opt,
                        args.finalize_workers,
                        device=aligner.device if paired else None)


def cmd_sormadup(args):
    from .sortdup.driver import sort_markdup, sort_markdup_file
    from .utils.device import resolve_device
    from .utils.profiling import PROF

    device = resolve_device(args.device)
    t0 = time.time()
    if args.input == "-":
        lines = sys.stdin.read().splitlines()
        n, ndup = sort_markdup(lines, args.output,
                               compress_level=args.compress_level,
                               device=device)
    else:
        # mmap-backed streaming path (inputs larger than RAM)
        n, ndup = sort_markdup_file(args.input, args.output,
                                    compress_level=args.compress_level,
                                    device=device)
    print(f"[sormadup] {n} records, {ndup} duplicate pairs, "
          f"{time.time()-t0:.1f}s -> {args.output}(.bai)", file=sys.stderr)
    PROF.display_stats(units=n, unit_name="records")
    return n, ndup


def _bam_to_read_dicts(path):
    from .call.readcache import bam_record_to_read_dict
    from .io import bam as bamio

    _, names, lens, records = bamio.read_bam(path)
    reads = [d for d in map(bam_record_to_read_dict, records)
             if d is not None]
    return names, lens, reads


def _sample_name(path, default):
    """SM of the BAM's first @RG line (the reference feeds the merged
    header's read groups to VCFWriter.writeHeader, main.cpp:598-600)."""
    from .io.bam import BamReader
    try:
        rdr = BamReader(path)
    except (OSError, ValueError):
        return default
    try:
        for line in rdr.header_text.splitlines():
            if line.startswith("@RG"):
                for f in line.split("\t"):
                    if f.startswith("SM:"):
                        return f[3:]
    finally:
        rdr.close()
    return default


def cmd_mutect(args):
    import dataclasses
    import os

    from .call.engine import (Mutect2Engine, apply_filter_mutect_calls,
                              write_vcf)
    from .config import CallConfig
    from .io.fasta import read_fasta
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    ref = read_fasta(args.reference)
    overrides = {k: v for k, v in dict(
        callable_depth=args.callable_depth,
        max_prob_propagation_distance=args.max_prob_propagation_distance,
        active_prob_threshold=args.active_probability_threshold,
        assembly_region_padding=args.assembly_region_padding,
        max_assembly_region_size=args.max_assembly_region_size,
        min_assembly_region_size=args.min_assembly_region_size,
        max_reads_per_alignment_start=args.max_reads_per_alignment_start,
    ).items() if v is not None}
    if args.kmer_size:
        overrides["kmer_sizes"] = tuple(sorted(args.kmer_size))
    cfg = dataclasses.replace(CallConfig(), **overrides)
    workers = max(args.threads - 1, 0)

    # --bqsr-within-mutect (reference main.cpp:204-211): recalibrate
    # base qualities from per-sample recal tables before calling
    from .call.bqsr import BQSRReadTransformer
    t_bqsr = BQSRReadTransformer(args.bqsr_tumor) if args.bqsr_tumor \
        else None
    n_bqsr = BQSRReadTransformer(args.bqsr_normal) if args.bqsr_normal \
        else None

    def engine(codes, cname):
        return Mutect2Engine(codes, cname, cfg=cfg,
                             cnn_model_path=args.deep_model,
                             region_workers=workers, device=device)

    all_calls = []
    callable_sites = 0
    streamed = os.path.exists(args.input + ".bai") and \
        (not args.normal or os.path.exists(args.normal + ".bai"))
    if streamed:
        # BAI-windowed streaming (reference ReadCache region loop,
        # main.cpp:254): one 1 Mb window + padding resident at a time,
        # with per-alignment-start downsampling applied per window
        from .call.readcache import StreamingReadSource

        src = StreamingReadSource(args.input, args.normal, cfg=cfg,
                                  tumor_bqsr=t_bqsr, normal_bqsr=n_bqsr)
        try:
            for cid, cname in enumerate(ref.names):
                if cname not in src.names:
                    continue
                rid = src.names.index(cname)
                codes = ref.contig_codes(cid)
                eng = engine(codes, cname)
                try:
                    all_calls.extend(
                        eng.call_windows(src.windows(rid, codes)))
                finally:
                    eng.close()
                callable_sites += eng.callable_sites
        finally:
            src.close()
    else:
        # whole-BAM path (no .bai next to the input)
        from .call.readcache import downsample_reads
        from .call.transformers import palindrome_artifact_clip

        _, _, tumor = _bam_to_read_dicts(args.input)
        normal = _bam_to_read_dicts(args.normal)[2] if args.normal else []
        for reads, bqsr in ((tumor, t_bqsr), (normal, n_bqsr)):
            if bqsr is not None:
                for r in reads:
                    bqsr.apply(r)
        for cid, cname in enumerate(ref.names):
            codes = ref.contig_codes(cid)
            t = [r for r in tumor if r["rid"] == cid]
            nr = [r for r in normal if r["rid"] == cid]
            if not t:
                continue
            t = downsample_reads(t, cfg.max_reads_per_alignment_start)
            nr = downsample_reads(nr, cfg.max_reads_per_alignment_start,
                                  seed=1)
            # per-read hairpin-artifact clip (ReadCache.cpp:27,115)
            for r in t + nr:
                palindrome_artifact_clip(r, codes)
            eng = engine(codes, cname)
            try:
                all_calls.extend(eng.call(t, nr))
            finally:
                eng.close()
            callable_sites += eng.callable_sites
    # --panel-of-normals: blacklist sites seen in the PoN VCF
    # (PanelOfNormalsFilter via the IN_PON annotation)
    if args.pon:
        from .io.vcf import read_vcf_sites
        pon = read_vcf_sites(args.pon)
        for c in all_calls:
            c.in_pon = (c.contig, c.pos + 1, c.ref, c.alt) in pon
    # FilterMutectCalls 2-pass (reference main.cpp:643-662)
    apply_filter_mutect_calls(all_calls,
                              callable_sites=max(callable_sites, 1))
    write_vcf(args.output, all_calls, ref.names,
              np.diff(ref.offsets).tolist(),
              tumor_sample=_sample_name(args.input, "tumor"),
              normal_sample=_sample_name(args.normal, "normal")
              if args.normal else None)
    print(f"[mutect] {len(all_calls)} calls -> {args.output}",
          file=sys.stderr)


def cmd_pipeline(args):
    """FASTQ -> sorted+markdup BAM (-> VCF): the three programs chained
    with stage overlap instead of materialized SAM pipes."""
    from .pipeline_stream import stream_fastq_to_bam
    from .utils.profiling import PROF

    if args.vcf and not args.reference:
        raise SystemExit("pipeline: --vcf needs -R ref.fa")
    aligner = load_aligner(args.prefix, args.batch, device=args.device)
    t0 = time.time()

    def progress(n):
        dt = max(time.time() - t0, 1e-9)
        print(f"[pipeline] {n} reads aligned, {n/dt:.0f} reads/s",
              file=sys.stderr)

    paired = len(args.reads) == 2
    pool = None
    if args.finalize_workers > 0:
        pool = _finalize_pool(args, aligner, paired)
    try:
        n, (nrec, ndup) = stream_fastq_to_bam(
            aligner, _timed_batches(args.reads, args.batch), args.output,
            paired=paired, compress_level=args.compress_level,
            progress=progress, pool=pool)
    finally:
        if pool is not None:
            pool.shutdown()
    print(f"[pipeline] {nrec} records, {ndup} duplicate pairs -> "
          f"{args.output}(.bai)", file=sys.stderr)
    PROF.display_stats(units=n, unit_name="reads")
    out = (n, nrec, ndup)
    if args.vcf:
        cmd_mutect(argparse.Namespace(
            reference=args.reference, input=args.output,
            normal=args.normal, output=args.vcf, device=args.device,
            threads=args.threads, pon=None, deep_model=None,
            bqsr_tumor=None, bqsr_normal=None, callable_depth=None,
            max_prob_propagation_distance=None,
            active_probability_threshold=None,
            assembly_region_padding=None, max_assembly_region_size=None,
            min_assembly_region_size=None,
            max_reads_per_alignment_start=None, kmer_size=None))
    return out


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
    pm.add_argument("-t", "--finalize-workers", type=int, default=0,
                    help="SAM-finalize worker processes (worker_sam "
                         "team analogue) [0]")
    pm.set_defaults(fn=cmd_mem)

    ps = sub.add_parser("sormadup")
    ps.add_argument("input", help="SAM file, or - for stdin")
    ps.add_argument("output")
    ps.add_argument("-l", "--compress-level", type=int, default=6)
    ps.add_argument("--device", default=None,
                    help="torch device of the sort [cuda]; 'cpu' runs "
                         "it on the CPU")
    ps.set_defaults(fn=cmd_sormadup)

    pc = sub.add_parser("mutect")
    pc.add_argument("-R", "--reference", required=True)
    pc.add_argument("-I", "--input", required=True)
    pc.add_argument("-N", "--normal")
    pc.add_argument("-O", "--output", required=True)
    pc.add_argument("--device", default=None,
                    help="torch device of the PairHMM [cuda]; 'cpu' runs "
                         "it on the CPU")
    pc.add_argument("-t", "--threads", type=int, default=1,
                    help="host threads: t-1 region workers run assembly "
                         "and genotyping in parallel (reference "
                         "main.cpp:195 N-thread region scheduler)")
    pc.add_argument("--panel-of-normals", dest="pon",
                    help="PoN VCF; matching sites get the "
                         "panel_of_normals filter")
    pc.add_argument("--deep-model",
                    help="TorchScript CNN gate (trans.pt); its forward "
                         "runs on --device")
    pc.add_argument("--bqsr-tumor", help="GATK recal table for tumor reads")
    pc.add_argument("--bqsr-normal",
                    help="GATK recal table for normal reads")
    # M2ArgumentCollection long options (reference main.cpp:449-531)
    pc.add_argument("--callable-depth", type=int)
    pc.add_argument("--max-prob-propagation-distance", type=int)
    pc.add_argument("--active-probability-threshold", type=float)
    pc.add_argument("--assembly-region-padding", type=int)
    pc.add_argument("--max-assembly-region-size", type=int)
    pc.add_argument("--min-assembly-region-size", type=int)
    pc.add_argument("--max-reads-per-alignment-start", type=int)
    pc.add_argument("--kmer-size", type=int, action="append",
                    help="assembly kmer size (repeatable) [10, 25]")
    pc.set_defaults(fn=cmd_mutect)

    pp = sub.add_parser("pipeline",
                        help="fastq -> sorted/markdup BAM (-> VCF), "
                             "stages overlapped")
    pp.add_argument("prefix")
    pp.add_argument("reads", nargs="+")
    pp.add_argument("-O", "--output", required=True, help="output BAM")
    pp.add_argument("-b", "--batch", type=int, default=512)
    pp.add_argument("-l", "--compress-level", type=int, default=6)
    pp.add_argument("-t", "--finalize-workers", type=int, default=0,
                    help="SAM-finalize worker processes (worker_sam "
                         "kt_for team analogue; 0 = in-process)")
    pp.add_argument("--device", default=None,
                    help="torch device [cuda]; 'cpu' runs every stage on "
                         "the CPU")
    pp.add_argument("--vcf", help="also call variants to this VCF")
    pp.add_argument("--threads", type=int, default=1,
                    help="mutect-stage host threads (threads-1 region "
                         "workers), used only with --vcf [1]")
    pp.add_argument("-R", "--reference", help="FASTA (required with --vcf)")
    pp.add_argument("-N", "--normal", help="normal BAM (with --vcf)")
    pp.set_defaults(fn=cmd_pipeline)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
