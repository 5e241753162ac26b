"""BAM encode/decode + BAI index (htslib-format replacement, host side).

The reference links stock htslib for BAM/BAI and relies on out-of-tree
parallel-writer extensions (sortmardup/main.cpp:406-437). This module
implements the formats directly: records encode independently (so shards
compress in parallel), and the BAI builder works from the uncompressed
stream offsets + the BGZF block table (bgzf.VirtualOffsetMap), which is
exactly the virtual-offset bookkeeping `merge_index`/`hts_idx_finish3`
performed.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bgzf

_SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NT16_STR = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"


def reg2bin(beg: int, end: int) -> int:
    """BAI bin of [beg, end) (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_tags(fields):
    out = bytearray()
    for tag in fields:
        name, typ, val = tag.split(":", 2)
        out += name.encode()
        if typ == "i":
            # htslib picks the narrowest integer type by value; SAM text
            # prints uint32 tags as 'i' too, so range-dispatch like hts
            v = int(val)
            if -(1 << 31) <= v < (1 << 31):
                out += b"i" + struct.pack("<i", v)
            elif 0 <= v < (1 << 32):
                out += b"I" + struct.pack("<I", v)
            else:
                raise ValueError(f"integer tag out of range: {tag}")
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ == "A":
            out += b"A" + val[:1].encode()
        elif typ == "Z":
            out += b"Z" + val.encode() + b"\0"
        elif typ == "H":
            out += b"H" + val.encode() + b"\0"
        elif typ == "B":
            sub = val[0]
            nums = val[2:].split(",") if len(val) > 2 else []
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I", "f": "f"}[sub]
            out += b"B" + sub.encode() + struct.pack("<I", len(nums))
            for x in nums:
                out += struct.pack("<" + fmt,
                                   float(x) if sub == "f" else int(x))
    return bytes(out)


def encode_record(fields, name_to_rid, flag_override=None):
    """SAM columns (list[str]) -> raw BAM alignment record bytes."""
    qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq, qual = \
        fields[:11]
    flag = int(flag) if flag_override is None else flag_override
    rid = name_to_rid.get(rname, -1)
    pos0 = int(pos) - 1
    from .sam import parse_cigar
    cig = parse_cigar(cigar)
    nrid = rid if rnext == "=" else name_to_rid.get(rnext, -1)
    pnext0 = int(pnext) - 1
    l_seq = 0 if seq == "*" else len(seq)
    rlen = sum(ln for op, ln in cig if op in (0, 2, 3, 7, 8))
    bin_ = reg2bin(pos0, pos0 + max(rlen, 1)) if rid >= 0 else 4680
    body = bytearray()
    body += struct.pack("<iiBBHHHiiii", rid, pos0, len(qname) + 1, int(mapq),
                        bin_, len(cig), flag, l_seq, nrid, pnext0, int(tlen))
    body += qname.encode() + b"\0"
    for op, ln in cig:
        body += struct.pack("<I", ln << 4 | op)
    if l_seq:
        s = seq.upper()
        for i in range(0, l_seq, 2):
            hi = _SEQ_NT16.get(s[i], 15) << 4
            lo = _SEQ_NT16.get(s[i + 1], 15) if i + 1 < l_seq else 0
            body.append(hi | lo)
        if qual == "*":
            body += b"\xff" * l_seq
        else:
            body += bytes(max(0, min(93, ord(c) - 33)) for c in qual)
    body += _encode_tags(fields[11:])
    body = bytes(body)
    return struct.pack("<I", len(body)) + body


def bam_header_bytes(text: str, names, lens) -> bytes:
    out = bytearray(b"BAM\1")
    t = text.encode()
    out += struct.pack("<i", len(t)) + t
    out += struct.pack("<i", len(names))
    for n, l in zip(names, lens):
        nb = n.encode() + b"\0"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
    return bytes(out)


class BaiBuilder:
    """BAI index accumulated from (rid, pos, end, voffset_beg, voffset_end)
    in coordinate order (hts_idx_push semantics)."""

    def __init__(self, n_ref: int):
        self.n_ref = n_ref
        self.bins = [dict() for _ in range(n_ref)]    # bin -> [chunks]
        self.linear = [dict() for _ in range(n_ref)]  # 16kb win -> min voff
        # pseudo-bin 37450 metadata per ref (hts_idx_push):
        # [voff_beg_min, voff_end_max, n_mapped, n_unmapped]
        self.meta = [[None, None, 0, 0] for _ in range(n_ref)]
        self.n_no_coor = 0

    def add(self, rid, beg, end, voff_beg, voff_end):
        if rid < 0:
            self.n_no_coor += 1
            return
        b = reg2bin(beg, end)
        chunks = self.bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_beg:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_beg, voff_end))
        # callers add in coordinate order with nondecreasing voffsets,
        # so setdefault keeps the window minimum
        for w in range(beg >> 14, (max(end - 1, beg) >> 14) + 1):
            self.linear[rid].setdefault(w, voff_beg)
        m = self.meta[rid]
        m[0] = voff_beg if m[0] is None else min(m[0], voff_beg)
        m[1] = voff_end if m[1] is None else max(m[1], voff_end)
        m[2] += 1

    def add_batch(self, rids, begs, ends, voff_begs, voff_ends):
        """Vectorized add() over coordinate-ordered records (the scalar
        add costs microseconds per record); equal to per-record add()
        byte for byte (tests/test_torch_sortdup.py)."""
        rids = np.asarray(rids, np.int64)
        begs = np.asarray(begs, np.int64)
        ends = np.asarray(ends, np.int64)
        vb = np.asarray(voff_begs, np.uint64)
        ve = np.asarray(voff_ends, np.uint64)
        no_coor = rids < 0
        self.n_no_coor += int(no_coor.sum())
        keep = ~no_coor
        if not keep.any():
            return
        rids, begs, ends = rids[keep], begs[keep], ends[keep]
        vb, ve = vb[keep], ve[keep]
        e1 = np.maximum(ends - 1, begs)
        # vectorized reg2bin (SAM spec 5.3): finest matching level wins
        # (every hit is nonzero, so 0 doubles as both the unset marker
        # and the no-level-matched whole-chromosome bin)
        bins = np.full(len(begs), 0, np.int64)
        for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9),
                            (26, 1)):
            hit = (begs >> shift) == (e1 >> shift)
            bins = np.where((bins == 0) & hit, base + (begs >> shift),
                            bins)
        for rid in np.unique(rids):
            m = rids == rid
            r_bins, r_vb, r_ve = bins[m], vb[m], ve[m]
            r_begs, r_e1 = begs[m], e1[m]
            bdict = self.bins[rid]
            for b in np.unique(r_bins):
                bm = r_bins == b
                bvb, bve = r_vb[bm], r_ve[bm]
                chunks = bdict.setdefault(int(b), [])
                # merge runs where a record starts at the previous
                # record's end voffset (add()'s chunk coalescing)
                new_run = np.ones(len(bvb), bool)
                new_run[1:] = bvb[1:] != bve[:-1]
                starts = np.flatnonzero(new_run)
                ends_i = np.append(starts[1:], len(bvb)) - 1
                first = 0
                if chunks and chunks[-1][1] == bvb[0]:
                    chunks[-1] = (chunks[-1][0], int(bve[ends_i[0]]))
                    first = 1
                for s, e in zip(starts[first:], ends_i[first:]):
                    chunks.append((int(bvb[s]), int(bve[e])))
            # linear index: the FIRST record (in call order) touching a
            # 16kb window sets its voffset — records span multiple
            # windows, so gather every (window, record-order) pair and
            # keep the earliest per window
            lin = self.linear[rid]
            w0 = r_begs >> 14
            w1 = r_e1 >> 14
            span = w1 - w0
            ws_l, vv_l, oi_l = [], [], []
            for extra in range(int(span.max()) + 1 if len(span) else 0):
                sel = span >= extra
                ws_l.append((w0[sel] + extra).astype(np.int64))
                vv_l.append(r_vb[sel])
                oi_l.append(np.flatnonzero(sel))
            if ws_l:
                W = np.concatenate(ws_l)
                V = np.concatenate(vv_l)
                O = np.concatenate(oi_l)
                ordw = np.lexsort((O, W))
                W, V = W[ordw], V[ordw]
                firstw = np.ones(len(W), bool)
                firstw[1:] = W[1:] != W[:-1]
                for w, v in zip(W[firstw].tolist(), V[firstw].tolist()):
                    lin.setdefault(int(w), int(v))
            m_ = self.meta[rid]
            lo, hi = int(r_vb.min()), int(r_ve.max())
            m_[0] = lo if m_[0] is None else min(m_[0], lo)
            m_[1] = hi if m_[1] is None else max(m_[1], hi)
            m_[2] += int(m.sum())

    def tobytes(self) -> bytes:
        out = bytearray(b"BAI\1")
        out += struct.pack("<i", self.n_ref)
        for rid in range(self.n_ref):
            bins = self.bins[rid]
            meta = self.meta[rid]
            out += struct.pack("<i", len(bins) + (1 if meta[2] else 0))
            for b in sorted(bins):
                chunks = bins[b]
                out += struct.pack("<Ii", b, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            if meta[2]:
                # metadata pseudo-bin 37450 (samtools idxstats source)
                out += struct.pack("<Ii", 37450, 2)
                out += struct.pack("<QQ", meta[0], meta[1])
                out += struct.pack("<QQ", meta[2], meta[3])
            lin = self.linear[rid]
            n_win = (max(lin) + 1) if lin else 0
            out += struct.pack("<i", n_win)
            filled = 0
            for w in range(n_win):
                v = lin.get(w, filled)
                if w in lin:
                    filled = lin[w]
                out += struct.pack("<Q", v)
        out += struct.pack("<Q", self.n_no_coor)
        return bytes(out)


# ---------------------------------------------------------------------------
# reader (for verification + downstream Mutect2 ingestion)
# ---------------------------------------------------------------------------

def read_bam(path):
    """Inflate + decode a BAM file -> (header_text, names, lens, records).
    Each record is a dict of core fields + raw tag bytes."""
    with open(path, "rb") as f:
        data = bgzf.decompress(f.read())
    assert data[:4] == b"BAM\1"
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = data[8:8 + l_text].decode(errors="replace")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    names, lens = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 4
        names.append(data[off:off + l_name - 1].decode())
        off += l_name
        lens.append(struct.unpack_from("<i", data, off)[0])
        off += 4
    records = []
    while off + 4 <= len(data):
        sz = struct.unpack_from("<I", data, off)[0]
        off += 4
        records.append(_decode_record(data[off:off + sz]))
        off += sz
    return text, names, lens, records


def cigar_to_str(cig):
    return "".join(f"{ln}{_CIGAR_OPS[op]}" for op, ln in cig) if cig else "*"


def _decode_record(rec) -> dict:
    """Decode one raw BAM record (without the leading block_size)."""
    (rid, pos, l_qname, mapq, bin_, n_cig, flag, l_seq, nrid, npos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
    p = 32
    qname = rec[p:p + l_qname - 1].decode()
    p += l_qname
    cig = []
    for _ in range(n_cig):
        v = struct.unpack_from("<I", rec, p)[0]
        p += 4
        cig.append((v & 0xf, v >> 4))
    seq = []
    for i in range(l_seq):
        b = rec[p + (i >> 1)]
        seq.append(_NT16_STR[(b >> 4) if i % 2 == 0 else (b & 0xf)])
    p += (l_seq + 1) // 2
    qual = rec[p:p + l_seq]
    p += l_seq
    return dict(qname=qname, flag=flag, rid=rid, pos=pos, mapq=mapq,
                cigar=cig, next_rid=nrid, next_pos=npos, tlen=tlen,
                seq="".join(seq), qual=bytes(qual), tags=bytes(rec[p:]))


def reg2bins(beg: int, end: int):
    """All BAI bins overlapping [beg, end) (SAM spec 5.3, hts_reg2bins)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


def read_bai(path):
    """Parse a .bai file -> list per ref of (bins dict {bin: [(vbeg,
    vend)]}, ioffsets uint64 array). Skips the 37450 metadata bin."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"BAI\1", "bad BAI magic"
    n_ref = struct.unpack_from("<i", data, 4)[0]
    off = 8
    refs = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", data, off)[0]
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                vb, ve = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((vb, ve))
            if b != 37450:
                bins[b] = chunks
        n_intv = struct.unpack_from("<i", data, off)[0]
        off += 4
        ioff = np.frombuffer(data, "<u8", n_intv, off).copy()
        off += 8 * n_intv
        refs.append((bins, ioff))
    return refs


class BamReader:
    """Region-windowed BAM access via the BAI index — the framework's
    ReadCache ingestion layer (reference read/ReadCache.h:32, readData
    ReadCache.cpp): fetch only the reads overlapping a region instead of
    loading the whole BAM."""

    def __init__(self, path, bai_path=None):
        self.path = path
        self.f = open(path, "rb")
        self._index = None
        self._bai_path = bai_path or path + ".bai"
        # decode header blocks lazily: inflate from 0 until header done
        buf = b""
        coff = 0
        while True:
            payload, bsize = bgzf.inflate_block_at(self.f, coff)
            if bsize == 0:
                break
            buf += payload
            coff += bsize
            if self._try_header(buf):
                break
        self.body_start = None  # virtual offset of first record unknown;
        # BAI chunks carry record offsets, so it is not needed.

    def _try_header(self, buf) -> bool:
        if len(buf) >= 4 and buf[:4] != b"BAM\1":
            raise ValueError(f"{self.path}: not a BAM file")
        if len(buf) < 12:
            return False
        l_text = struct.unpack_from("<i", buf, 4)[0]
        off = 8 + l_text
        if len(buf) < off + 4:
            return False
        n_ref = struct.unpack_from("<i", buf, off)[0]
        off += 4
        names, lens = [], []
        for _ in range(n_ref):
            if len(buf) < off + 4:
                return False
            l_name = struct.unpack_from("<i", buf, off)[0]
            off += 4
            if len(buf) < off + l_name + 4:
                return False
            names.append(buf[off:off + l_name - 1].decode())
            off += l_name
            lens.append(struct.unpack_from("<i", buf, off)[0])
            off += 4
        self.header_text = buf[8:8 + l_text].decode(errors="replace")
        self.names, self.lens = names, lens
        return True

    @property
    def index(self):
        if self._index is None:
            self._index = read_bai(self._bai_path)
        return self._index

    def fetch(self, rid: int, beg: int, end: int):
        """Records overlapping [beg, end) on rid, in file order."""
        bins, ioff = self.index[rid]
        min_voff = 0
        if len(ioff):
            w = min(beg >> 14, len(ioff) - 1)
            min_voff = int(ioff[w])
        chunks = []
        for b in reg2bins(beg, end):
            for vb, ve in bins.get(b, ()):
                if ve > min_voff:
                    chunks.append((max(vb, min_voff), ve))
        if not chunks:
            return []
        # merge adjacent/overlapping chunks to minimize inflation
        chunks.sort()
        merged = [list(chunks[0])]
        for vb, ve in chunks[1:]:
            if vb >> 16 <= merged[-1][1] >> 16:   # same/adjacent block
                merged[-1][1] = max(merged[-1][1], ve)
            else:
                merged.append([vb, ve])
        out = []
        for vb, ve in merged:
            data = bgzf.read_virtual_range(self.f, vb, ve)
            off = 0
            while off + 4 <= len(data):
                sz = struct.unpack_from("<I", data, off)[0]
                off += 4
                if off + sz > len(data):
                    break
                r_rid, r_pos = struct.unpack_from("<ii", data, off)
                if r_rid == rid and r_pos < end:
                    rec = _decode_record(data[off:off + sz])
                    span = sum(ln for op, ln in rec["cigar"]
                               if op in (0, 2, 3, 7, 8))
                    r_end = r_pos + max(span, 1)
                    if r_end > beg:
                        out.append(rec)
                off += sz
        return out

    def close(self):
        self.f.close()
