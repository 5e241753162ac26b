"""Plain readers of the port's output: BAM (BGZF, zlib) and SAM text,
into one table of records; and writers of both, for the control, which
stands in the port's place. NumPy and the standard library only; nothing
of the port or of the JAX package.

A record: name, flag, ref (index into the header's references, -1 for
none), pos (0-based), mapq, cigar [(op, length)], seq (codes 0-4 as
uint8, as stored: the forward strand), rnext (index, -1), pnext
(0-based), tlen, and the AS and NM tags (None when absent). A BAM is read
as a Table: the columns every record gives at once (vectorised over the
decompressed file), whole records on demand.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
import zlib

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
_SEQ16 = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4], np.uint8)
_ASCII = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ASCII[_c] = _i
    _ASCII[_c + 32] = _i


@dataclasses.dataclass
class Record:
    name: str
    flag: int
    ref: int
    pos: int
    mapq: int
    cigar: list
    seq: np.ndarray
    rnext: int
    pnext: int
    tlen: int
    AS: int | None
    NM: int | None


def _aux_int(buf: bytes, off: int, end: int) -> dict:
    """The integer tags among a BAM record's auxiliary fields."""
    sizes = {b"A": 1, b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4,
             b"f": 4}
    ints = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i",
            b"I": "<I"}
    out = {}
    while off < end:
        tag = buf[off:off + 2].decode()
        t = buf[off + 2:off + 3]
        off += 3
        if t in ints:
            out[tag] = struct.unpack_from(ints[t], buf, off)[0]
            off += sizes[t]
        elif t in sizes:
            off += sizes[t]
        elif t in (b"Z", b"H"):
            off = buf.index(b"\0", off) + 1
        elif t == b"B":
            sub = buf[off:off + 1]
            n = struct.unpack_from("<i", buf, off + 1)[0]
            off += 5 + n * sizes[sub]
        else:
            raise ValueError(f"unknown BAM tag type {t!r}")
    return out


@dataclasses.dataclass
class Table:
    """Records as columns (what the whole-file checks read) and, for
    the few records a check reads whole, `record(i)`."""
    names: list
    flag: np.ndarray
    ref: np.ndarray
    pos: np.ndarray
    lead: np.ndarray       # clips before the first aligned operation
    tail: np.ndarray       # clips after the last
    span: np.ndarray       # reference bases the alignment covers
    record: object         # i -> Record

    @classmethod
    def of(cls, recs):
        """The table of a list of Records."""
        clips = [_clips(r.cigar) for r in recs]
        col = lambda k: np.array([getattr(r, k) for r in recs], np.int64)
        return cls([r.name for r in recs], col("flag"), col("ref"),
                   col("pos"),
                   np.array([c[0] for c in clips], np.int64),
                   np.array([c[1] for c in clips], np.int64),
                   np.array([c[2] for c in clips], np.int64),
                   recs.__getitem__)


def _clips(cigar):
    core = [i for i, (op, _) in enumerate(cigar) if op not in "SH"]
    if not core:
        return 0, 0, 0
    lead = sum(n for op, n in cigar[:core[0]])
    tail = sum(n for op, n in cigar[core[-1] + 1:])
    span = sum(n for op, n in cigar if op in "MDN=X")
    return lead, tail, span


def _gather(arr, offs, dtype):
    """The little-endian `dtype` field at each byte offset."""
    w = np.dtype(dtype).itemsize
    return arr[offs[:, None] + np.arange(w)].copy().view(dtype)[:, 0]


def bgzf_decompress(data: bytes) -> bytes:
    """The concatenated payload of a BGZF file's blocks (gzip members of
    at most 64 KiB, each with its size in the BC extra field), one raw
    inflate a block."""
    out, off, mv = [], 0, memoryview(data)
    while off < len(data):
        if data[off:off + 2] != b"\x1f\x8b" or not data[off + 3] & 4:
            return gzip.decompress(data)           # not BGZF: plain gzip
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        p, end, bsize = off + 12, off + 12 + xlen, None
        while p < end:
            si, slen = data[p:p + 2], struct.unpack_from("<H", data, p + 2)[0]
            if si == b"BC":
                bsize = struct.unpack_from("<H", data, p + 4)[0]
            p += 4 + slen
        if bsize is None:
            return gzip.decompress(data)
        out.append(zlib.decompress(mv[end:off + bsize + 1 - 8], -15))
        off += bsize + 1
    return b"".join(out)


def read_bam(path):
    """(reference names, reference lengths, Table) of a BAM file."""
    with open(path, "rb") as f:
        buf = bgzf_decompress(f.read())
    if buf[:4] != b"BAM\1":
        raise ValueError(f"{path} is not a BAM file")
    l_text = struct.unpack_from("<i", buf, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, off)[0]
    off += 4
    names, lens = [], []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", buf, off)[0]
        names.append(buf[off + 4:off + 4 + ln - 1].decode())
        lens.append(struct.unpack_from("<i", buf, off + 4 + ln)[0])
        off += 8 + ln
    starts = []
    size = struct.Struct("<i")
    while off < len(buf):
        starts.append(off)
        off += 4 + size.unpack_from(buf, off)[0]
    arr = np.frombuffer(buf, np.uint8)
    o = np.asarray(starts, np.int64)
    ref = _gather(arr, o + 4, "<i4").astype(np.int64)
    pos = _gather(arr, o + 8, "<i4").astype(np.int64)
    l_name = arr[o + 12].astype(np.int64)
    n_cig = _gather(arr, o + 16, "<u2").astype(np.int64)
    flag = _gather(arr, o + 18, "<u2").astype(np.int64)
    qnames = [buf[a + 36:a + 35 + n].decode()
              for a, n in zip(starts, l_name.tolist())]
    # every CIGAR word of every record, flattened
    rec_of = np.repeat(np.arange(len(o)), n_cig)
    first = np.cumsum(n_cig) - n_cig
    k = np.arange(len(rec_of)) - first[rec_of]
    words = _gather(arr, (o + 36 + l_name)[rec_of] + 4 * k, "<u4")
    op = (words & 15).astype(np.int64)
    ln = (words >> 4).astype(np.int64)
    clip = (op == 4) | (op == 5)
    big = np.iinfo(np.int64).max
    first_core = np.full(len(o), big)
    last_core = np.full(len(o), -1)
    np.minimum.at(first_core, rec_of[~clip], k[~clip])
    np.maximum.at(last_core, rec_of[~clip], k[~clip])
    lead = np.bincount(rec_of, ln * (clip & (k < first_core[rec_of])),
                       len(o)).astype(np.int64)
    tail = np.bincount(rec_of, ln * (clip & (k > last_core[rec_of])),
                       len(o)).astype(np.int64)
    on_ref = np.isin(op, (0, 2, 3, 7, 8))
    span = np.bincount(rec_of, ln * on_ref, len(o)).astype(np.int64)
    return names, lens, Table(qnames, flag, ref, pos, lead, tail, span,
                              lambda i: _bam_record(buf, starts[i]))


def _bam_record(buf, off):
    """The whole record at byte offset `off` of the decompressed BAM."""
    size = struct.unpack_from("<i", buf, off)[0]
    (ref, pos, l_name, mapq, _bin, n_cig, flag, l_seq, rnext, pnext,
     tlen) = struct.unpack_from("<iiBBHHHiiii", buf, off + 4)
    p = off + 36
    name = buf[p:p + l_name - 1].decode()
    p += l_name
    cig = struct.unpack_from(f"<{n_cig}I", buf, p)
    p += 4 * n_cig
    packed = np.frombuffer(buf, np.uint8, (l_seq + 1) // 2, p)
    seq = np.empty(2 * len(packed), np.uint8)
    seq[0::2] = _SEQ16[packed >> 4]
    seq[1::2] = _SEQ16[packed & 15]
    p += (l_seq + 1) // 2 + l_seq
    tags = _aux_int(buf, p, off + 4 + size)
    return Record(name, flag, ref, pos, mapq,
                  [(CIGAR_OPS[c & 15], c >> 4) for c in cig], seq[:l_seq],
                  rnext, pnext, tlen, tags.get("AS"), tags.get("NM"))


def _cigar(s: str) -> list:
    out, num = [], 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((ch, num))
            num = 0
    return out


def read_sam(path):
    """(reference names, reference lengths, [Record]) of a SAM file."""
    names, lens, recs = [], [], []
    with open(path) as f:
        for ln in f:
            if ln.startswith("@"):
                if ln.startswith("@SQ"):
                    kv = dict(x.split(":", 1) for x in
                              ln.rstrip("\n").split("\t")[1:])
                    names.append(kv["SN"])
                    lens.append(int(kv["LN"]))
                continue
            f_ = ln.rstrip("\n").split("\t")
            ref = names.index(f_[2]) if f_[2] != "*" else -1
            rnext = ref if f_[6] == "=" else \
                (names.index(f_[6]) if f_[6] != "*" else -1)
            tags = {}
            for t in f_[11:]:
                if t[3:5] == "i:":
                    tags[t[:2]] = int(t[5:])
            seq = _ASCII[np.frombuffer(f_[9].encode(), np.uint8)] \
                if f_[9] != "*" else np.zeros(0, np.uint8)
            recs.append(Record(f_[0], int(f_[1]), ref, int(f_[3]) - 1,
                               int(f_[4]),
                               _cigar(f_[5]) if f_[5] != "*" else [],
                               seq, rnext, int(f_[7]) - 1, int(f_[8]),
                               tags.get("AS"), tags.get("NM")))
    return names, lens, recs


def _encode(rec: Record) -> bytes:
    """One BAM record: the fields above, qualities absent (0xff), AS and
    NM as int32 tags where set."""
    code = {c: i for i, c in enumerate(CIGAR_OPS)}
    nm = rec.name.encode() + b"\0"
    cig = b"".join(struct.pack("<I", n << 4 | code[op])
                   for op, n in rec.cigar)
    nib = np.array([1, 2, 4, 8, 15], np.uint8)[np.asarray(rec.seq)]
    if len(nib) % 2:
        nib = np.append(nib, 0)
    packed = (nib[0::2] << 4 | nib[1::2]).astype(np.uint8).tobytes()
    aux = b"".join(t.encode() + b"i" + struct.pack("<i", v)
                   for t, v in (("AS", rec.AS), ("NM", rec.NM))
                   if v is not None)
    body = struct.pack("<iiBBHHHiiii", rec.ref, rec.pos, len(nm), rec.mapq,
                       0, len(rec.cigar), rec.flag, len(rec.seq), rec.rnext,
                       rec.pnext, rec.tlen) + nm + cig + packed + \
        b"\xff" * len(rec.seq) + aux
    return struct.pack("<i", len(body)) + body


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block: a gzip member with its size in the BC field."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = c.compress(data) + c.flush()
    head = b"\x1f\x8b\x08\x04" + b"\0" * 4 + b"\0\xff\x06\0BC\x02\0"
    return head + struct.pack("<H", len(cdata) + 25) + cdata + \
        struct.pack("<II", zlib.crc32(data), len(data))


def write_bam(path, ref_names, ref_lens, recs):
    """A BAM file of the records, in the order given."""
    text = b"@HD\tVN:1.6\tSO:coordinate\n"
    head = b"BAM\1" + struct.pack("<i", len(text)) + text + \
        struct.pack("<i", len(ref_names))
    for n, ln in zip(ref_names, ref_lens):
        head += struct.pack("<i", len(n) + 1) + n.encode() + b"\0" + \
            struct.pack("<i", ln)
    data = head + b"".join(_encode(r) for r in recs)
    with open(path, "wb") as f:
        for i in range(0, len(data), 65280):
            f.write(_bgzf_block(data[i:i + 65280]))
        f.write(_bgzf_block(b""))


def write_sam(path, ref_names, ref_lens, recs):
    """A SAM file of the records, in the order given."""
    name = lambda i: ref_names[i] if i >= 0 else "*"
    with open(path, "w") as f:
        for n, ln in zip(ref_names, ref_lens):
            f.write(f"@SQ\tSN:{n}\tLN:{ln}\n")
        for r in recs:
            cig = "".join(f"{n}{op}" for op, n in r.cigar) or "*"
            nxt = "=" if r.rnext == r.ref and r.rnext >= 0 else name(r.rnext)
            seq = bytes(b"ACGTN"[c] for c in r.seq).decode() or "*"
            tags = "".join(f"\t{t}:i:{v}" for t, v in (("AS", r.AS),
                                                      ("NM", r.NM))
                           if v is not None)
            f.write(f"{r.name}\t{r.flag}\t{name(r.ref)}\t{r.pos + 1}\t"
                    f"{r.mapq}\t{cig}\t{nxt}\t{r.pnext + 1}\t{r.tlen}\t"
                    f"{seq}\t*{tags}\n")
