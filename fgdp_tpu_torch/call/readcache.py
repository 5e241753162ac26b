"""Region-windowed BAM read source with per-alignment-start downsampling.

The reference's ReadCache (deepmutect/Mutect2Cpp-master/src/read/
ReadCache.{h,cpp}) iterates the BAM one 1 Mb region at a time through an
htslib iterator, groups pending reads by alignment start, and downsamples
groups larger than maxReadsPerAlignmentStart (DEFAULT_MAX_COVERAGE=50,
ReadCache.h:58; downSample ReadCache.cpp:169-184: keep reads with
mapq > SUSPICIOUS_MAPPING_QUALITY=50, then a random cap), applying the
palindrome-artifact clip and optional BQSR transformers on the fly
(ReadCache.cpp:27,115).

This module is the framework's equivalent over io/bam.BamReader (BAI
windowed fetch) — reads never materialize beyond one window + padding,
so whole-genome BAMs stream at O(window) memory.
"""

from __future__ import annotations

import numpy as np

from ..io.bam import BamReader
from ..utils import dna
from .engine import _ReadIndex
from .transformers import palindrome_artifact_clip

SUSPICIOUS_MAPPING_QUALITY = 50


def bam_record_to_read_dict(r):
    """BAM record dict (io/bam._decode_record) -> engine read dict.
    Returns None for secondary/supplementary/unmapped/duplicate records
    (the reference's ReadFilter pass)."""
    if r["flag"] & 0x904 or r["rid"] < 0:
        return None
    return dict(
        rid=r["rid"], pos=r["pos"], cigar=r["cigar"],
        seq_codes=dna.encode(r["seq"]).astype(np.int64),
        quals=np.frombuffer(r["qual"], np.uint8).astype(np.int64),
        mate_start=r["next_pos"] if r["next_rid"] == r["rid"] else None,
        properly_paired=bool(r["flag"] & 0x2), flag=r["flag"],
        mapq=r["mapq"], is_reverse=bool(r["flag"] & 0x10),
        frag_len=r["tlen"])


def downsample_reads(reads, max_per_start, seed=0):
    """Per-alignment-start downsampling (ReadCache.cpp:127-184).

    Groups reads by `pos`; a group larger than max_per_start first drops
    reads with mapq <= SUSPICIOUS_MAPPING_QUALITY, then randomly caps at
    max_per_start. Deviation from the reference: the shuffle is seeded
    (reference uses std::random_device) so runs are reproducible.
    """
    if max_per_start is None or max_per_start <= 0:
        return list(reads)
    reads = sorted(reads, key=lambda r: r["pos"])
    rng = np.random.default_rng(seed)
    out = []
    i = 0
    n = len(reads)
    while i < n:
        j = i
        while j < n and reads[j]["pos"] == reads[i]["pos"]:
            j += 1
        group = reads[i:j]
        if len(group) > max_per_start:
            filtered = [r for r in group
                        if r["mapq"] > SUSPICIOUS_MAPPING_QUALITY]
            if len(filtered) > max_per_start:
                order = rng.permutation(len(filtered))[:max_per_start]
                filtered = [filtered[k] for k in sorted(order)]
            group = filtered
        out.extend(group)
        i = j
    return out


class StreamingReadSource:
    """BAI-windowed read source for Mutect2Engine.call_windows.

    Yields (rstart, rend, t_index, n_index) windows for one contig;
    each window's indexes cover [rstart - pad, rend + pad) with
    downsampling + transformers applied (reads are fetched once per
    window — the reference's advance-one-region semantics)."""

    def __init__(self, tumor_path, normal_path=None, cfg=None,
                 tumor_bqsr=None, normal_bqsr=None):
        self.t_reader = BamReader(tumor_path)
        self.n_reader = BamReader(normal_path) if normal_path else None
        self.cfg = cfg
        self.tumor_bqsr = tumor_bqsr
        self.normal_bqsr = normal_bqsr
        self.names = self.t_reader.names
        self.lens = self.t_reader.lens

    def _window_reads(self, reader, rid, lo, hi, bqsr, ref_codes, seed):
        recs = reader.fetch(rid, lo, hi)
        reads = []
        for r in recs:
            d = bam_record_to_read_dict(r)
            if d is not None:
                reads.append(d)
        reads = downsample_reads(
            reads, self.cfg.max_reads_per_alignment_start if self.cfg
            else 50, seed=seed)
        if bqsr is not None:
            for r in reads:
                bqsr.apply(r)
        for r in reads:
            palindrome_artifact_clip(r, ref_codes)
        return reads

    def windows(self, rid, ref_codes, region_size=None, padding=None):
        """Generator of engine windows for contig `rid`."""
        cfg = self.cfg
        region_size = region_size or (cfg.region_size if cfg else 1_000_000)
        padding = padding if padding is not None else (
            (cfg.assembly_region_padding + cfg.max_assembly_region_size)
            if cfg else 400)
        n = int(self.lens[rid])
        for rstart in range(0, n, region_size):
            rend = min(rstart + region_size, n)
            lo, hi = max(rstart - padding, 0), min(rend + padding, n)
            t = self._window_reads(self.t_reader, rid, lo, hi,
                                   self.tumor_bqsr, ref_codes,
                                   seed=rstart)
            if not t:
                continue
            nr = self._window_reads(self.n_reader, rid, lo, hi,
                                    self.normal_bqsr, ref_codes,
                                    seed=rstart + 1) \
                if self.n_reader is not None else []
            yield rstart, rend, _ReadIndex(t), _ReadIndex(nr)

    def close(self):
        self.t_reader.close()
        if self.n_reader is not None:
            self.n_reader.close()
