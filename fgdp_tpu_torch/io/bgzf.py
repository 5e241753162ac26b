"""BGZF blocks (the htslib bgzf layer, reimplemented): compressing for
the BAM writer, and inflating a whole stream, one block, or the bytes
between two virtual offsets.

The reference consumes htslib's bgzf for BAM output and relies on five
out-of-tree extensions (bam_write_idx2/bgzf_flush2/hts_close2/merge_index/
hts_idx_finish3, sortmardup/main.cpp:406-437) to compress shards in
parallel and merge them; this module provides the same capability
natively: independent `compress_block` calls parallelize trivially and
blocks concatenate into a valid BGZF stream.
"""

from __future__ import annotations

import struct
import zlib

MAX_BLOCK = 0xFF00   # uncompressed payload cap per block

EOF_BLOCK = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00])


def compress_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF block (gzip member with BC extra field)."""
    assert len(data) <= MAX_BLOCK
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 18 + 8 - 1   # header(18) + payload + footer(8), -1
    header = struct.pack("<4BIBBHBBHH", 0x1f, 0x8b, 8, 4, 0, 0, 0xff, 6,
                         66, 67, 2, bsize)
    footer = struct.pack("<II", zlib.crc32(data) & 0xffffffff,
                         len(data) & 0xffffffff)
    return header + comp + footer


def compress_stream(data: bytes, level: int = 6, threads: int = 8):
    """Split data into BGZF blocks; returns (bytes, block_table) where
    block_table = [(uncompressed_start, compressed_start, ulen)] — the
    bookkeeping needed to compute virtual offsets for the index.

    Streams above four blocks go to the native pthread-parallel
    compressor (the reference's out-of-tree bgzf_flush2 parallel writer,
    sortmardup/main.cpp:406); shorter ones to serial zlib, as in the JAX
    package, so both write the same bytes."""
    if len(data) > 4 * MAX_BLOCK and threads > 1:
        from . import native
        return native.bgzf_compress(data, level, threads)
    out = []
    table = []
    coff = 0
    for i in range(0, max(len(data), 1), MAX_BLOCK):
        chunk = data[i:i + MAX_BLOCK]
        blk = compress_block(chunk, level)
        table.append((i, coff, len(chunk)))
        out.append(blk)
        coff += len(blk)
    return b"".join(out), table


class VirtualOffsetMap:
    """Map uncompressed stream offsets -> BGZF virtual offsets
    (coffset << 16 | uoffset within block)."""

    def __init__(self, table, base_coff: int = 0):
        self.table = table
        self.base = base_coff

    def voffset(self, uoff: int) -> int:
        lo, hi = 0, len(self.table)
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if self.table[mid][0] <= uoff:
                lo = mid
            else:
                hi = mid
        ustart, coff, _ = self.table[lo]
        return ((self.base + coff) << 16) | (uoff - ustart)

    def voffsets(self, uoffs) -> "np.ndarray":
        """Vectorized voffset over an array of uncompressed offsets."""
        import numpy as np
        u = np.asarray(uoffs, np.int64)
        ustarts = np.asarray([t[0] for t in self.table], np.int64)
        coffs = np.asarray([t[1] for t in self.table], np.int64)
        idx = np.clip(np.searchsorted(ustarts, u, "right") - 1, 0,
                      len(self.table) - 1)
        return ((self.base + coffs[idx]) << 16) | (u - ustarts[idx])


def decompress(data: bytes) -> bytes:
    """Inflate a BGZF stream (reader side)."""
    out = []
    off = 0
    while off + 18 <= len(data):
        if data[off:off + 2] != b"\x1f\x8b":
            raise ValueError("bad BGZF magic")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        bsize = None
        xoff = off + 12
        end = xoff + xlen
        while xoff + 4 <= end:
            si1, si2, slen = data[xoff], data[xoff + 1], \
                struct.unpack_from("<H", data, xoff + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", data, xoff + 4)[0] + 1
            xoff += 4 + slen
        if bsize is None:
            raise ValueError("missing BC subfield")
        comp = data[off + 12 + xlen:off + bsize - 8]
        out.append(zlib.decompress(comp, -15))
        off += bsize
    return b"".join(out)


def inflate_block_at(f, coff: int):
    """Inflate the single BGZF block starting at compressed offset coff
    of open binary file f. Returns (payload bytes, compressed size)."""
    f.seek(coff)
    hdr = f.read(18)
    if len(hdr) < 18 or hdr[:2] != b"\x1f\x8b":
        return b"", 0
    xlen = struct.unpack_from("<H", hdr, 10)[0]
    extra = hdr[12:] + f.read(max(xlen - 6, 0))
    bsize = None
    xoff = 0
    while xoff + 4 <= len(extra):
        si1, si2, slen = extra[xoff], extra[xoff + 1], \
            struct.unpack_from("<H", extra, xoff + 2)[0]
        if si1 == 66 and si2 == 67:
            bsize = struct.unpack_from("<H", extra, xoff + 4)[0] + 1
        xoff += 4 + slen
    if bsize is None:
        raise ValueError("missing BC subfield")
    comp = f.read(bsize - 12 - xlen - 8)
    f.read(8)
    return zlib.decompress(comp, -15), bsize


def read_virtual_range(f, v_beg: int, v_end: int) -> bytes:
    """Uncompressed bytes between two BGZF virtual offsets
    (coffset << 16 | uoffset). v_end's block is inflated fully when
    uoffset lands inside it (records may spill past; caller bounds by
    record framing)."""
    coff = v_beg >> 16
    u0 = v_beg & 0xFFFF
    cend = v_end >> 16
    uend = v_end & 0xFFFF
    out = []
    first = True
    while True:
        payload, bsize = inflate_block_at(f, coff)
        if bsize == 0:
            break
        lo = u0 if first else 0
        if coff == cend:
            out.append(payload[lo:uend])
            break
        out.append(payload[lo:])
        first = False
        coff += bsize
        if coff > cend:
            break
    return b"".join(out)
