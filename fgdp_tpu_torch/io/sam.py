"""SAM text model: parse to struct-of-arrays, duplicate-key fields.

Plays the role of sortmardup's BamParser/BAMRecord layer
(sortmardup/tbb/bam_parser.cpp, bam_record.cpp): records are grouped by
QNAME in file order, mates paired (first two non-ignorable records of a
group), and the Picard-compatible duplicate keys computed:
  * unified coordinate  kTable[tid] + pos   (main.cpp:96-103)
  * unclipped 5' position prime5_pos        (bam_record.cpp:26-62)
  * score = sum of quals >= 15              (bam_record.cpp:7-16)
  * tile/X/Y from Illumina QNAME            (tbb/pair.cpp:22-49)
  * ignorable = unmapped|secondary|supplementary (bam_parser.cpp:54-58)
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

FUNMAP, FSECONDARY, FSUP = 0x4, 0x100, 0x800
FREVERSE = 0x10
FDUP = 0x400

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")
_OP_CODE = {b"M": 0, b"I": 1, b"D": 2, b"N": 3, b"S": 4, b"H": 5,
            b"P": 6, b"=": 7, b"X": 8}
# ops consuming reference: M, D, N, =, X (bam_cigar_type & 2)
_CONSUMES_REF = {0, 2, 3, 7, 8}
_CLIPS = {4, 5}


@dataclasses.dataclass
class SamHeader:
    names: list
    lens: list
    text: str

    @classmethod
    def parse(cls, lines) -> "SamHeader":
        names, lens, raw = [], [], []
        for ln in lines:
            raw.append(ln if isinstance(ln, str) else ln.decode())
            if ln.startswith("@SQ" if isinstance(ln, str) else b"@SQ"):
                s = ln if isinstance(ln, str) else ln.decode()
                d = dict(f.split(":", 1) for f in s.strip().split("\t")[1:])
                names.append(d["SN"])
                lens.append(int(d["LN"]))
        return cls(names=names, lens=lens, text="\n".join(raw) + "\n")

    def ktable(self) -> np.ndarray:
        """kTable prefix sums + trailing total (unmapped bucket),
        sortmardup/main.cpp:96-103."""
        k = np.zeros(len(self.lens) + 1, np.int64)
        k[1:] = np.cumsum(self.lens)
        return k


def cigar_ref_len(cig) -> int:
    return sum(ln for op, ln in cig if op in _CONSUMES_REF)


def parse_cigar(s: bytes):
    if s in (b"*", "*"):
        return []
    if isinstance(s, str):
        s = s.encode()
    return [(_OP_CODE[m.group(2)], int(m.group(1)))
            for m in _CIGAR_RE.finditer(s)]


def tile_x_y(qname: str):
    """Illumina QNAME -> (tile, x, y) (tbb/pair.cpp:22-49); uint16 range."""
    parts = qname.split(":")
    try:
        if len(parts) == 7:
            v = (int(parts[4]), int(parts[5]), int(parts[6]))
        elif len(parts) == 6:
            v = (int(parts[3]), int(parts[4]), int(parts[5]))
        else:
            return (0, 0, 0)
        if all(0 <= x < 0x10000 for x in v):
            return v
    except ValueError:
        pass
    return (0, 0, 0)


@dataclasses.dataclass
class SamRecords:
    """Struct-of-arrays over SAM records, in file order."""

    qname: list                 # str per record
    flag: np.ndarray            # int32
    rid: np.ndarray             # int32 (-1 unmapped)
    pos: np.ndarray             # int64 0-based
    mapq: np.ndarray            # int32
    cigars: list                # [(op, len)] per record
    fields: list                # full column list per record (re-emission)
    # derived
    ucoord: np.ndarray          # int64 unified coordinate
    prime5: np.ndarray          # int64 unclipped 5' position
    score: np.ndarray           # int32 sum of quals >= 15
    tile: np.ndarray            # int32
    tx: np.ndarray              # int32
    ty: np.ndarray              # int32
    pair_id: np.ndarray         # int64; 0 = ignorable

    def __len__(self):
        return len(self.flag)


def parse_sam_records(lines, header: SamHeader) -> SamRecords:
    """lines: iterable of SAM body lines (str). Pairing follows
    BamParser::pop_record: consecutive same-QNAME records; the first two
    non-ignorable ones share a pairID."""
    kt = header.ktable()
    name_to_rid = {n: i for i, n in enumerate(header.names)}

    qnames, flags, rids, poss, mapqs, cigars, fields = [], [], [], [], [], [], []
    scores, tiles, txs, tys = [], [], [], []
    for ln in lines:
        if isinstance(ln, bytes):
            ln = ln.decode()
        ln = ln.rstrip("\n")
        if not ln or ln.startswith("@"):
            continue
        f = ln.split("\t")
        qnames.append(f[0])
        flags.append(int(f[1]))
        rids.append(name_to_rid.get(f[2], -1))
        poss.append(int(f[3]) - 1)
        mapqs.append(int(f[4]))
        cigars.append(parse_cigar(f[5]))
        fields.append(f)
        q = f[10]
        scores.append(0 if q == "*" else
                      sum(c - 33 for c in q.encode() if c - 33 >= 15))
        t, x, y = tile_x_y(f[0])
        tiles.append(t)
        txs.append(x)
        tys.append(y)

    n = len(qnames)
    flag = np.array(flags, np.int32) if n else np.zeros(0, np.int32)
    rid = np.array(rids, np.int32) if n else np.zeros(0, np.int32)
    pos = np.array(poss, np.int64) if n else np.zeros(0, np.int64)

    ucoord = np.where(rid >= 0, kt[np.maximum(rid, 0)] + pos, kt[-1])
    prime5 = ucoord.copy()
    for i in range(n):
        cig = cigars[i]
        if not cig:
            continue
        if not (flag[i] & FREVERSE):
            for op, ln_ in cig:
                if op in _CLIPS:
                    prime5[i] -= ln_
                else:
                    break
        else:
            j = len(cig) - 1
            while j >= 0 and cig[j][0] in _CLIPS:
                prime5[i] += cig[j][1]
                j -= 1
            prime5[i] += sum(ln_ for op, ln_ in cig[:j + 1]
                             if op in _CONSUMES_REF)
            prime5[i] -= 1

    ignorable = (flag & (FUNMAP | FSECONDARY | FSUP)) != 0
    pair_id = np.zeros(n, np.int64)
    next_id = 1
    i = 0
    while i < n:
        j = i
        while j < n and qnames[j] == qnames[i]:
            j += 1
        # BamParser: record1 = pop front; record2 = first non-ignorable
        # same-QNAME record (removed from the queue; ignorable records in
        # between stay queued and become later record1s)
        group = list(range(i, j))
        while group:
            r1 = group.pop(0)
            next_id += 1        # a pairID is consumed per record1
            if ignorable[r1]:
                continue
            pair_id[r1] = next_id - 1
            for gi, r2 in enumerate(group):
                if not ignorable[r2]:
                    pair_id[r2] = next_id - 1
                    group.pop(gi)
                    break
        i = j

    return SamRecords(
        qname=qnames, flag=flag, rid=rid, pos=pos,
        mapq=np.array(mapqs, np.int32) if n else np.zeros(0, np.int32),
        cigars=cigars, fields=fields, ucoord=ucoord, prime5=prime5,
        score=np.array(scores, np.int32) if n else np.zeros(0, np.int32),
        tile=np.array(tiles, np.int32) if n else np.zeros(0, np.int32),
        tx=np.array(txs, np.int32) if n else np.zeros(0, np.int32),
        ty=np.array(tys, np.int32) if n else np.zeros(0, np.int32),
        pair_id=pair_id,
    )
