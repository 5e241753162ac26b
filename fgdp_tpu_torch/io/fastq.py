"""FASTQ chunked reader producing fixed-shape device-ready batches.

Plays the role of kseq/bseq_read_orig (reference:
bwa-mem2-lcp/ext/TAL/ext/bseq.cpp:114, src/kseq.h): reads are pulled in
chunks sized by total bp (mem_opt chunk_size semantics) and padded into
(B, read_len) uint8 code matrices with a length vector — the fixed-shape
contract every jitted stage relies on.
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np


@dataclasses.dataclass
class ReadBatch:
    names: list                  # B read names (host only)
    codes: np.ndarray            # uint8[B, L] base codes, 4 past length
    quals: np.ndarray            # uint8[B, L] phred (0 past length)
    lengths: np.ndarray          # int32[B]
    comments: list | None = None

    @property
    def n_reads(self) -> int:
        return len(self.lengths)


def _open(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def parse_fastq_records(path):
    """Yield (name, comment, seq_bytes, qual_bytes)."""
    with _open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            hdr = hdr.strip()
            if not hdr:
                continue
            seq = f.readline().strip()
            f.readline()  # '+'
            qual = f.readline().strip()
            fields = hdr[1:].split(None, 1)
            name = fields[0].decode()
            comment = fields[1].decode() if len(fields) > 1 else None
            yield name, comment, seq, qual


def read_batches(path, read_len: int = 151, chunk_bp: int = 10_000_000,
                 pad_multiple: int = 512):
    """Stream ReadBatches of ~chunk_bp total bases, padded to pad_multiple,
    through the native C parser (io/native.py) — the role of the
    reference's C bseq_read_orig chunk reader."""
    from . import native

    max_reads = max(1, chunk_bp // max(read_len, 1))
    buf = b""
    f = _open(path)
    try:
        while True:
            chunk = f.read(chunk_bp * 3)
            buf += chunk
            if not buf:
                return
            res = native.parse_fastq_chunk(buf, max_reads, read_len)
            names, codes, quals, lens, consumed = res
            if not names:
                if not chunk:
                    return
                continue
            buf = buf[consumed:]
            n = len(names)
            b = -(-n // pad_multiple) * pad_multiple
            pc = np.full((b, read_len), 4, np.uint8)
            pq = np.zeros((b, read_len), np.uint8)
            pl = np.zeros(b, np.int32)
            pc[:n] = codes
            pq[:n] = quals
            pl[:n] = lens
            yield ReadBatch(names=names, codes=pc, quals=pq, lengths=pl)
            if not chunk and not buf:
                return
    finally:
        f.close()
