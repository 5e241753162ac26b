"""Contig-sharded ("split") index: align against K independent
per-contig-group indexes and merge per-read candidate regions.

Port of the JAX package's parallel/sharded_index.py. The reference packs
one suffix array over the full 2 x 3.2 Gbp text as 34-bit entries
(sa_low32/sa_high2, bwa-mem2-lcp/src/bwt.h:69-76) because a single index
must address more than 2^31 positions. Here the index is sharded by
contig groups instead: every shard's packed text (fwd + rc) stays below
2^31, so every device-side coordinate (SA entries, chain rbeg/rmax
windows, extension rb/re) stays int32, the type the kernels take, and
shard results are remapped to global int64 coordinates on the host,
where the reference also does its 64-bit arithmetic (sortmardup kTable,
main.cpp:96-103). All shards' aligners live on one device and their
programs run back to back: this is the single-card way to align against
a reference whose packed text exceeds int32.

Semantics: identical to running `mem` once per shard reference and
merging candidate regions before mem_sort_dedup_patch / primary
marking. For references whose shards share no >= seed-length repeats
this equals the joint-index output exactly (tested); on cross-shard
repeats, per-shard occurrence counts are lower than joint counts, so
seeding keeps strictly MORE candidates than a joint index would (the
chain filter's max_occ cut sees per-shard occ), never fewer.
"""

from __future__ import annotations

import numpy as np

from ..config import AlignConfig, BatchShapes
from ..index.fmindex import FMIndex
from ..index.reference import PackedReference
from ..pipeline import Aligner, finalize_pe_batch, finalize_se_batch
from ..utils.device import resolve_device


def partition_contigs(lens, n_shards: int):
    """Greedy contiguous partition of contigs into n_shards groups,
    balanced by total length. Returns list of (lo, hi) contig-index
    ranges (hi exclusive), one per shard; fewer groups when there are
    fewer contigs than shards."""
    n = len(lens)
    n_shards = max(1, min(n_shards, n))
    total = int(np.sum(lens))
    target = total / n_shards
    groups = []
    lo = 0
    acc = 0
    for i in range(n):
        acc += int(lens[i])
        groups_left = n_shards - len(groups)
        contigs_left = n - i - 1
        # close the group when it reaches its share — or when exactly
        # enough contigs remain to give every later group one
        if groups_left > 1 and (acc >= target
                                or contigs_left == groups_left - 1):
            groups.append((lo, i + 1))
            lo = i + 1
            acc = 0
    groups.append((lo, n))
    return groups


def slice_reference(pref: PackedReference, lo: int, hi: int) \
        -> PackedReference:
    """Shard sub-reference [lo, hi) by SLICING the already-randomized
    global codes (re-running from_contigs would re-randomize ambiguous
    bases differently and break parity with the joint index)."""
    b0 = int(pref.offsets[lo])
    b1 = int(pref.offsets[hi])
    keep = (pref.amb_offsets >= b0) & (pref.amb_offsets < b1)
    return PackedReference(
        names=list(pref.names[lo:hi]),
        lens=pref.lens[lo:hi].copy(),
        offsets=(pref.offsets[lo:hi + 1] - b0).copy(),
        codes=pref.codes[b0:b1],
        amb_offsets=(pref.amb_offsets[keep] - b0),
        amb_lens=pref.amb_lens[keep].copy(),
        is_alt=pref.is_alt[lo:hi].copy(),
    )


def merge_shard_regs(pref: PackedReference, groups, shard_l_pacs,
                     shard_regs):
    """Per-shard regs dicts (shard coordinates, int32) -> one regs dict
    in global coordinates: rb/re int64 in the joint [0, 2 * l_pac)
    space, rid offset by the shard's first contig, each read's slots
    concatenated shard after shard."""
    merged = None
    L_g = pref.l_pac
    for (lo, _), l_s, regs in zip(groups, shard_l_pacs, shard_regs):
        off = int(pref.offsets[lo])
        rb = regs["rb"].astype(np.int64)
        re = regs["re"].astype(np.int64)
        fwd = rb < l_s
        shift_fwd = off
        shift_rc = 2 * L_g - 2 * l_s - off
        rb = np.where(fwd, rb + shift_fwd, rb + shift_rc)
        re = np.where(fwd, re + shift_fwd, re + shift_rc)
        regs = dict(regs)
        regs["rb"], regs["re"] = rb, re
        regs["rid"] = np.where(regs["rid"] >= 0, regs["rid"] + lo,
                               regs["rid"])
        if merged is None:
            merged = regs
        else:
            for k, v in regs.items():
                if getattr(v, "ndim", 0) == 2:
                    merged[k] = np.concatenate([merged[k], v], axis=1)
            merged["overflow"] = merged["overflow"] | regs["overflow"]
            # frac_rep: repeat fraction vs the union of shard hits
            merged["frac_rep"] = np.maximum(merged["frac_rep"],
                                            regs["frac_rep"])
    return merged


class ShardedAligner:
    """K per-shard aligners on one device + global-coordinate host
    finalize. Drop-in for pipeline.Aligner's align_batch/align_pairs
    surface. device=None runs on the CUDA card and raises without one."""

    def __init__(self, pref: PackedReference, n_shards: int = 2,
                 opt: AlignConfig | None = None,
                 shapes: BatchShapes | None = None, lcp=True,
                 shard_fms=None, device=None):
        """shard_fms: optional pre-built per-shard FMIndex list (built
        here when None). lcp is each shard's Aligner's: True builds the
        shard's LcpTree and seeds on the LCP engine; False (or None)
        seeds on the sweep and builds no tree, the layout for a reference
        whose trees do not fit the card."""
        self.device = resolve_device(device)
        self.pref = pref                      # global (finalize side)
        self.opt = opt or AlignConfig()
        self.shapes = shapes or BatchShapes()
        self.groups = partition_contigs(pref.lens, n_shards)
        self.shards = []
        for s, (lo, hi) in enumerate(self.groups):
            sp = slice_reference(pref, lo, hi)
            if not 2 * sp.l_pac < 2**31:
                raise ValueError("shard text exceeds int32: raise "
                                 "n_shards")
            fm = shard_fms[s] if shard_fms is not None \
                else FMIndex.build(sp.codes)
            self.shards.append(Aligner(sp, fm, opt=self.opt,
                                       shapes=self.shapes, lcp=lcp,
                                       device=self.device))

    def sam_header(self, rg_line=None):
        return Aligner.sam_header(self, rg_line)   # uses self.pref

    # ---- device step ----

    def _device_regs(self, seq_codes):
        """Dispatch every shard's device program, then convert and
        escalate per shard and merge to one global-coordinate regs dict
        (int64 rb/re)."""
        bufs = [sh._device_regs_async(seq_codes) for sh in self.shards]
        regs = [sh._regs_to_np(buf, seq_codes)
                for sh, buf in zip(self.shards, bufs)]
        return merge_shard_regs(self.pref, self.groups,
                                [sh.pref.l_pac for sh in self.shards],
                                regs)

    # ---- host finalize (global reference) ----

    def align_batch(self, names, seq_codes, quals=None, id0: int = 0):
        regs_np = self._device_regs(seq_codes)
        return finalize_se_batch(self.pref, self.opt, self.shapes, names,
                                 seq_codes, quals, regs_np, id0)

    def align_pairs(self, names, seq_codes, quals=None, id0: int = 0):
        """seq_codes interleaved [r1_0, r2_0, ...]; mate rescue on the
        aligner's device."""
        assert len(seq_codes) % 2 == 0
        regs_np = self._device_regs(seq_codes)
        return finalize_pe_batch(self.pref, self.opt, names, seq_codes,
                                 quals, regs_np, id0, self.device)
