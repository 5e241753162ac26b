"""Typed configuration of the alignment stage.

``AlignConfig`` mirrors ``mem_opt_t`` (reference:
bwa-mem2-lcp/src/bwamem.h:82-114, defaults ``mem_opt_init``
bwa-mem2-lcp/src/bwamem.cpp:106-141), with field names and defaults
preserving output parity with the reference program.

Static batching parameters (the analogue of the reference's compile-time
macros, bwa-mem2-lcp/src/macro.h:44-66) live in ``BatchShapes``. The port
keeps the JAX package's fixed per-read caps and overflow flags, so the
same reads escalate through the same ladder and the SAM output matches.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Alignment scoring/heuristic options (mem_opt_t parity)."""

    # scoring (bwamem.cpp:111-118)
    a: int = 1                 # match score
    b: int = 4                 # mismatch penalty
    o_del: int = 6             # gap open (deletion)
    e_del: int = 1             # gap extend (deletion)
    o_ins: int = 6             # gap open (insertion)
    e_ins: int = 1             # gap extend (insertion)
    w: int = 100               # band width
    T: int = 30                # output score threshold
    zdrop: int = 100           # Z-dropoff
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5

    # seeding (bwamem.cpp:120-127)
    max_mem_intv: int = 20     # K3 seed-strategy interval cap
    min_seed_len: int = 19
    split_width: int = 10
    max_occ: int = 500
    split_factor: float = 1.5

    # chaining
    max_chain_gap: int = 10000
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    drop_ratio: float = 0.50
    mask_level: float = 0.50
    mask_level_redun: float = 0.95

    # pairing / output
    max_ins: int = 10000
    max_matesw: int = 50
    XA_drop_ratio: float = 0.80
    output_all: bool = False          # MEM_F_ALL (-a)
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    mapQ_coef_len: float = 50.0

    # pipeline
    chunk_size: int = 10_000_000   # bp per batch (reference -K)

    @property
    def mapQ_coef_fac(self) -> int:
        # bwamem.h:109 declares mapQ_coef_fac as int, so log(50)=3.91
        # truncates to 3 (bwamem.cpp:139); MAPQ parity requires matching it.
        return int(math.log(self.mapQ_coef_len))

    def score_matrix(self):
        """5x5 substitution matrix, bwa_fill_scmat semantics: match=a,
        mismatch=-b, anything vs N (code 4) = -1."""
        import numpy as np

        m = np.full((5, 5), -self.b, dtype=np.int32)
        np.fill_diagonal(m, self.a)
        m[4, :] = -1
        m[:, 4] = -1
        return m


@dataclasses.dataclass(frozen=True)
class BatchShapes:
    """Static shapes for jit-compiled device programs.

    The TPU analogue of the reference's compile-time macros
    (READ_LEN=151, BATCH_SIZE=512, SEEDS_PER_READ=500; macro.h:44-66).
    All device buffers are padded to these bounds; overflow falls back to
    wider buckets on the host driver.
    """

    read_len: int = 151          # max read length (macro.h READ_LEN)
    batch_reads: int = 512       # reads per device batch
    seed_scale: int = 1          # widens seeding-internal lane/entry
    # caps (prev_cap, entry slots, shared backward lane pool) — the
    # overflow-escalation ladder multiplies this along with the buffer
    # bounds below (Aligner._retry_overflow)
    max_smems: int = 160         # SMEM buffer slots per read
    # seeding-machine emit-buffer widths (None = max_smems). Narrow
    # buffers cut the per-while-step one-hot append bandwidth (~10 ms
    # of a 118 ms 500 kb batch at 64/32) but on repeat-rich genomes
    # half the reads exceed them and escalate (measured 50% overflow on
    # the chr20-scale campaign at 64/32 vs 2.5% at 160) — generous is
    # the production default; the caps stay tunable for uniform
    # workloads
    k1_emit_cap: int | None = None
    k3_emit_cap: int | None = None
    # flat-pool sizing overrides for escalated programs (0 = derive
    # from seed_scale as before): chain-stage job pool entries per read
    # and extension SW lanes per read
    jobs_pool_per_read: int = 0
    ext_jobs_per_read: int = 0
    # K2 re-seeding pool scale decoupled from seed_scale (0 = follow
    # seed_scale): the dominant seed-stage escalation class on
    # repeat-rich genomes is K2's prev/entry/backward pools, which can
    # widen without re-running K1 at doubled rounds
    k2_scale: int = 0
    max_seeds: int = 256         # seed buffer slots per read (after SA expansion)
    max_chains: int = 64         # chain slots per read
    max_regs: int = 48           # extension jobs / alignment regions per read
    # flat-wire valid-reg budget, average slots/read (pipeline.pack_regs);
    # 0 = escalated full width (transfer_regs)
    pack_cap: int = 6
    # device->host transfer width: regs are compacted valid-first on
    # device and only this many columns cross the (slow) PCIe/relay
    # link; a read with more valid regs sets overflow and rides the
    # escalation ladder (which widens this too)
    transfer_regs: int = 16
    # SW extension ref-window cap: must cover read_len + 2*cal_max_gap cap
    # (= w<<1, bwamem.cpp:75); 151 + 200 rounded up
    max_ext_ref: int = 368

    @classmethod
    def repeat_rich(cls, **kw):
        """Capacity profile for Alu-dense / real-genome workloads (the
        bwa `-x` profile idea applied to SPMD capacities): the flat
        seed-expansion job pool is the dominant primary-pass overflow
        cause on the 60 Mb chr20-class campaign genome (measured r5:
        jobs_pool 32->64 cut the escalating tail 22.4% -> 13.2%;
        + chains 96 + transfer 32 -> 9.6% at ~20% primary-pass cost).
        Uniform workloads (the 500 kb headline) keep the narrower
        defaults — ~0.02% of their reads escalate either way."""
        base = dict(jobs_pool_per_read=64, max_chains=96,
                    transfer_regs=32, pack_cap=8)
        base.update(kw)
        return cls(**base)
