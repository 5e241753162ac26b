"""Packed reference + contig metadata (the reference's bntseq layer).

Mirrors bntseq_t semantics (reference ext/TAL/ext/bntseq.cpp): contigs are
concatenated into a forward "pac" space of length l_pac; alignment
coordinates live in the doubled space [0, 2*l_pac) where positions >=
l_pac are on the reverse strand of the mirrored forward sequence
(bns_get_seq :435-463, bns_depos usage :407). Ambiguous bases are
replaced by deterministic pseudo-random ACGT (bns_fasta2bntseq semantics)
and their runs recorded (the .amb "holes" used by bns_cnt_ambi :412).

Device layout: forward codes as one int32 tensor + int32 contig offset
table on the aligner's device; window fetch/rid lookup are batched
gathers + searchsorted (DeviceReference below) instead of per-call
mallocs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass
class PackedReference:
    names: list           # contig names
    lens: np.ndarray      # int64[n]
    offsets: np.ndarray   # int64[n+1] cumulative starts; offsets[n] == l_pac
    codes: np.ndarray     # uint8[l_pac] forward codes (0..3, N randomized)
    amb_offsets: np.ndarray  # int64[n_holes] start of each ambiguous run
    amb_lens: np.ndarray     # int64[n_holes]
    is_alt: np.ndarray       # bool[n] ALT contigs (see load_alt)

    @property
    def l_pac(self) -> int:
        return int(self.offsets[-1])

    @classmethod
    def from_contigs(cls, names, seqs, seed: int = 11) -> "PackedReference":
        """seqs: list of uint8 code arrays (0..3, 4=ambiguous)."""
        rng = np.random.default_rng(seed)
        lens = np.array([len(s) for s in seqs], np.int64)
        offsets = np.zeros(len(seqs) + 1, np.int64)
        offsets[1:] = np.cumsum(lens)
        codes = np.concatenate([np.asarray(s, np.uint8) for s in seqs]) \
            if seqs else np.zeros(0, np.uint8)
        amb = codes > 3
        codes = np.where(amb, rng.integers(0, 4, codes.shape).astype(np.uint8),
                         codes)
        # run-length encode ambiguity holes
        d = np.diff(np.concatenate([[0], amb.view(np.uint8), [0]]).astype(np.int8))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        return cls(names=list(names), lens=lens, offsets=offsets,
                   codes=codes, amb_offsets=starts.astype(np.int64),
                   amb_lens=(ends - starts).astype(np.int64),
                   is_alt=np.zeros(len(seqs), bool))

    @classmethod
    def from_reference(cls, ref) -> "PackedReference":
        """From an io.fasta.Reference (already parsed + randomized)."""
        amb = ref.amb_mask
        d = np.diff(np.concatenate([[0], amb.view(np.uint8), [0]]).astype(np.int8))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        return cls(names=list(ref.names), lens=np.diff(ref.offsets),
                   offsets=np.asarray(ref.offsets, np.int64),
                   codes=np.asarray(ref.codes, np.uint8),
                   amb_offsets=starts.astype(np.int64),
                   amb_lens=(ends - starts).astype(np.int64),
                   is_alt=np.zeros(len(ref.names), bool))

    @classmethod
    def from_fasta(cls, path, seed: int = 11) -> "PackedReference":
        from ..io.fasta import read_fasta
        pref = cls.from_reference(read_fasta(path, randomize_seed=seed))
        pref.load_alt(str(path) + ".alt")
        return pref

    def load_alt(self, alt_path) -> None:
        """Mark ALT contigs from a bwa-style .alt file: the first
        tab-field of every non-'@' line names an alt contig
        (bns_restore, ext/TAL/ext/bntseq.cpp:199-224)."""
        import os
        if not os.path.exists(alt_path):
            return
        idx = {n: i for i, n in enumerate(self.names)}
        with open(alt_path) as f:
            for ln in f:
                name = ln.split("\t", 1)[0].strip()
                if name and not name.startswith("@") and name in idx:
                    self.is_alt[idx[name]] = True

    # ---- host coordinate helpers (bntseq.cpp parity) ----

    def pos2rid(self, pos_f: int) -> int:
        """bns_pos2rid: contig of a forward-space position (-1 if out)."""
        if pos_f >= self.l_pac:
            return -1
        return int(np.searchsorted(self.offsets, pos_f, side="right") - 1)

    def depos(self, pos: int):
        """bns_depos: doubled-space -> (forward pos, is_rev)."""
        is_rev = pos >= self.l_pac
        return (2 * self.l_pac - 1 - pos) if is_rev else pos, is_rev

    def intv2rid(self, rb: int, re: int) -> int:
        if rb < self.l_pac < re:
            return -2
        rid_b = self.pos2rid(self.depos(rb)[0])
        rid_e = self.pos2rid(self.depos(re - 1)[0]) if rb < re else rid_b
        return rid_b if rid_b == rid_e else -1

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """bns_get_seq: X[beg:end) in the doubled space (empty if
        bridging the strand boundary)."""
        beg, end = min(beg, end), max(beg, end)
        end = min(end, 2 * self.l_pac)
        beg = max(beg, 0)
        if beg < self.l_pac < end:
            return np.zeros(0, np.uint8)
        if beg >= self.l_pac:
            bf = 2 * self.l_pac - end
            ef = 2 * self.l_pac - beg
            return (3 - self.codes[bf:ef])[::-1].astype(np.uint8)
        return self.codes[beg:end]

    def fetch_window(self, beg: int, mid: int, end: int):
        """bns_fetch_seq: clamp [beg,end) to the contig+strand of mid,
        return (seq, beg, end, rid)."""
        pos_f, is_rev = self.depos(mid)
        rid = self.pos2rid(pos_f)
        fb, fe = int(self.offsets[rid]), int(self.offsets[rid + 1])
        if is_rev:
            fb, fe = 2 * self.l_pac - fe, 2 * self.l_pac - fb
        beg = max(beg, fb)
        end = min(end, fe)
        return self.get_seq(beg, end), beg, end, rid

    def save(self, path):
        np.savez(path, names=np.array(self.names), lens=self.lens,
                 offsets=self.offsets, codes=self.codes,
                 amb_offsets=self.amb_offsets, amb_lens=self.amb_lens,
                 is_alt=self.is_alt)

    @classmethod
    def load(cls, path) -> "PackedReference":
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        return cls(names=[str(n) for n in z["names"]], lens=z["lens"],
                   offsets=z["offsets"], codes=z["codes"],
                   amb_offsets=z["amb_offsets"], amb_lens=z["amb_lens"],
                   is_alt=z["is_alt"])


class DeviceReference:
    """Device-resident reference tensors + batched coordinate ops.

    All per-lane results are int32, as in the JAX package. The packed
    doubled-space words (16 codes per uint32) are held as int64 tensors
    carrying the uint32 values: torch has no uint32 arithmetic, and int64
    keeps every shift and mask exact."""

    def __init__(self, ref: PackedReference, device=None):
        """device=None places the tensors on the CUDA card (raises without
        one); pass device="cpu" for the CPU."""
        if not 2 * ref.l_pac < 2**31:
            raise ValueError("reference too large for int32 coordinates")
        self.device = resolve_device(device)
        self.codes = torch.as_tensor(np.asarray(ref.codes, np.int32),
                                     device=self.device)
        self.offsets = torch.as_tensor(np.asarray(ref.offsets, np.int32),
                                       device=self.device)      # [n+1]
        self.is_alt = torch.as_tensor(np.asarray(ref.is_alt, bool),
                                      device=self.device)
        self.l_pac = int(ref.l_pac)
        self.n_contigs = len(ref.names)
        # doubled-space text (fwd + revcomp) packed 16 codes/uint32:
        # window fetches gather 1/16 the rows of an element gather
        x = np.concatenate([np.asarray(ref.codes, np.uint8),
                            3 - np.asarray(ref.codes, np.uint8)[::-1]])
        nw = (len(x) + 15) // 16 + 1
        xp = np.zeros(nw * 16, np.uint32)
        xp[:len(x)] = x
        words = (xp.reshape(nw, 16) << (2 * np.arange(16, dtype=np.uint32))
                 ).sum(axis=1, dtype=np.uint32)
        self.codes16 = torch.as_tensor(words.astype(np.int64),
                                       device=self.device)

    def fetch(self, pos):
        """X[pos] for doubled-space positions (batched); out-of-range -> 4."""
        l2 = 2 * self.l_pac
        fwd = pos < self.l_pac
        pf = torch.where(fwd, pos, l2 - 1 - pos)
        base = self.codes[pf.clamp(0, self.l_pac - 1).long()]
        base = torch.where(fwd, base, 3 - base)
        return torch.where((pos >= 0) & (pos < l2), base,
                           4).to(torch.int32)

    def fetch_window(self, start, T: int, reverse: bool = False):
        """Contiguous doubled-space window codes: [J, T] int32 with 4 at
        out-of-range positions. reverse=True returns position
        start+T-1-c at column c (left-extension order). One packed-word
        gather per 16 codes instead of an element gather per code."""
        return packed_window(self.codes16, 2 * self.l_pac, start, T,
                             reverse)

    def pos2rid(self, pos_f):
        """Batched bns_pos2rid over forward-space positions."""
        rid = (torch.searchsorted(self.offsets, pos_f.contiguous(),
                                  right=True) - 1).to(torch.int32)
        return torch.where((pos_f >= 0) & (pos_f < self.l_pac), rid, -1)

    def depos(self, pos):
        is_rev = pos >= self.l_pac
        return torch.where(is_rev, 2 * self.l_pac - 1 - pos, pos), is_rev

    def intv2rid(self, rb, re):
        """Batched bns_intv2rid (bntseq.cpp:402-410)."""
        bridging = (rb < self.l_pac) & (re > self.l_pac)
        rid_b = self.pos2rid(self.depos(rb)[0])
        rid_e = torch.where(rb < re, self.pos2rid(self.depos(re - 1)[0]),
                            rid_b)
        rid = torch.where(rid_b == rid_e, rid_b, -1)
        return torch.where(bridging, -2, rid).to(torch.int32)

    def contig_window(self, mid):
        """Batched bns_fetch_seq clamp bounds: contig+strand span of mid
        in doubled space -> (far_beg, far_end, rid)."""
        pos_f, is_rev = self.depos(mid)
        rid = self.pos2rid(pos_f)
        fb = self.offsets[rid.clamp(0, self.n_contigs).long()]
        fe = self.offsets[(rid + 1).clamp(0, self.n_contigs).long()]
        l2 = 2 * self.l_pac
        far_beg = torch.where(is_rev, l2 - fe, fb).to(torch.int32)
        far_end = torch.where(is_rev, l2 - fb, fe).to(torch.int32)
        return far_beg, far_end, rid


_U32 = 0xFFFFFFFF


def packed_window(codes16, l2: int, start, T: int, reverse: bool = False):
    """Free-function form of DeviceReference.fetch_window (usable from
    code that carries the packed words without the full object).

    codes16 int64[nw] holding uint32 words; start int32[J]. Shifts run
    in int64, so `>>` on a negative start floors like the JAX package's
    arithmetic shift, and `& 15` is the nonnegative remainder."""
    start = start.to(torch.int64)
    W = T // 16 + 2
    dev = codes16.device
    w0 = start >> 4
    widx = (w0[:, None] + torch.arange(W, device=dev)[None, :]).clamp(
        0, codes16.shape[0] - 1)
    words = codes16[widx]                                   # [J, W]
    off = start & 15
    sh = 2 * off[:, None]
    aligned = torch.where(
        off[:, None] == 0, words[:, :-1],
        ((words[:, :-1] >> sh) | (words[:, 1:] << (32 - sh))) & _U32)
    cols = torch.arange(T, device=dev)
    wi = cols >> 4
    bi = 2 * (cols & 15)
    codes = (aligned[:, wi] >> bi[None, :]) & 3
    pos = start[:, None] + cols[None, :]
    codes = torch.where((pos >= 0) & (pos < l2), codes, 4).to(torch.int32)
    return codes.flip(1) if reverse else codes
