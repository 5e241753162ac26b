"""sormadup equivalent: SAM lines -> coordinate-sorted BAM + BAI with
duplicate flags (sortmardup/main.cpp pipeline, device sort + dup engine).

The native C parser extracts the numeric duplicate-key fields and
assigns pairIDs (io/native.py -> native/fgdp_native.cc), duplicate
marking + the coordinate sort run as torch ops on the device
(sortdup/engine.py), and the native encoder emits raw BAM records in
sorted order — the Python layer only glues arrays.

Port of the JAX package's sortdup/driver.py. The native library is
required, so its pure-Python fallback is not ported; the JAX package
pads the device arrays to powers of two to bound jit recompiles, which
torch does not need. Every entry point takes `device`: None is the CUDA
card (raises without one), "cpu" the CPU.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..io import bam as bamio
from ..io import bgzf
from ..io import native
from ..io.sam import FDUP, FREVERSE, SamHeader
from ..utils.device import resolve_device
from ..utils.profiling import PROF
from . import engine


def _dup_pids(prime5, flag, score, tile, tx, ty, pair_id, ref_len, device):
    """Device duplicate detection over numeric record arrays; returns the
    np.int64 array of duplicate pair_ids (main.cpp:249-341 semantics)."""
    vidx = np.nonzero(np.asarray(pair_id) > 0)[0]
    if len(vidx) == 0:
        return np.zeros(0, np.int64)
    pid = np.asarray(pair_id)[vidx]
    ids, inv, cnt = np.unique(pid, return_inverse=True, return_counts=True)
    order = np.argsort(inv, kind="stable")
    starts = np.zeros(len(ids), np.int64)
    starts[1:] = np.cumsum(cnt)[:-1]
    dbl = cnt >= 2
    sgl = cnt == 1
    d_i1 = vidx[order[starts[dbl]]]
    d_i2 = vidx[order[starts[dbl] + 1]]
    s_i = vidx[order[starts[sgl]]]

    # the engine takes at least one lane per side; a missing side is one
    # invalid lane
    ND, NS = max(len(d_i1), 1), max(len(s_i), 1)
    p1 = prime5[d_i1]
    p2 = prime5[d_i2]
    r1 = (flag[d_i1] & FREVERSE) != 0
    r2 = (flag[d_i2] & FREVERSE) != 0
    swap = p1 > p2
    p1s = np.where(swap, p2, p1)
    p2s = np.where(swap, p1, p2)
    r1s = np.where(swap, r2, r1)
    r2s = np.where(swap, r1, r2)
    orient = 2 * r1s.astype(np.int32) + r2s.astype(np.int32)
    orient = np.where((p1s == p2s) & (orient == 2), 1, orient)

    def pad(a, N, dt):
        out = np.zeros(N, dt)
        out[:len(a)] = a
        return torch.as_tensor(out, device=device)

    dup_dbl, dup_sgl = engine.mark_duplicates(
        pad(p1s, ND, np.int64), pad(orient, ND, np.int32),
        pad(p2s, ND, np.int64),
        pad(score[d_i1].astype(np.int64) + score[d_i2], ND, np.int32),
        pad(tile[d_i1], ND, np.int32), pad(tx[d_i1], ND, np.int32),
        pad(ty[d_i1], ND, np.int32), pad(np.ones(len(d_i1), bool), ND, bool),
        pad(prime5[s_i], NS, np.int64),
        pad(np.where((flag[s_i] & FREVERSE) != 0, 3, 0), NS, np.int32),
        pad(score[s_i], NS, np.int32), pad(tile[s_i], NS, np.int32),
        pad(tx[s_i], NS, np.int32), pad(ty[s_i], NS, np.int32),
        pad(np.ones(len(s_i), bool), NS, bool), int(ref_len))
    dup_dbl = dup_dbl.cpu().numpy()[:len(d_i1)]
    dup_sgl = dup_sgl.cpu().numpy()[:len(s_i)]
    return np.concatenate([
        np.asarray(pair_id)[d_i1[dup_dbl]],
        np.asarray(pair_id)[s_i[dup_sgl]]]).astype(np.int64)


def find_duplicates(records, ref_len: int, device=None) -> set:
    """Device duplicate detection over io/sam.SamRecords; returns the set
    of duplicate pair_ids."""
    dev = resolve_device(device)
    return set(_dup_pids(records.prime5, np.asarray(records.flag),
                         np.asarray(records.score), np.asarray(records.tile),
                         np.asarray(records.tx), np.asarray(records.ty),
                         records.pair_id, ref_len, dev).tolist())


def _sort_order_np(ucoord: np.ndarray, device) -> np.ndarray:
    uc = torch.as_tensor(np.asarray(ucoord, np.int64), device=device)
    valid = torch.ones(len(uc), dtype=torch.bool, device=device)
    return engine.coordinate_sort_order(uc, valid).cpu().numpy()


def sort_order(records, device=None) -> np.ndarray:
    return _sort_order_np(np.asarray(records.ucoord),
                          resolve_device(device))


def _sorted_header_bytes(header: SamHeader):
    """Set SO:coordinate on the existing @HD (never add a second @HD)."""
    lines = header.text.splitlines()
    had_hd = False
    for i, ln in enumerate(lines):
        if ln.startswith("@HD"):
            had_hd = True
            if "SO:" in ln:
                lines[i] = re.sub(r"SO:\S+", "SO:coordinate", ln)
            else:
                lines[i] = ln + "\tSO:coordinate"
            break
    if not had_hd:
        lines.insert(0, "@HD\tVN:1.6\tSO:coordinate")
    htext = "\n".join(lines) + "\n"
    return bamio.bam_header_bytes(htext, header.names, header.lens)


def _sort_markdup_native(data, header: SamHeader, out_bam_path,
                         compress_level: int, device,
                         batch_records: int = 200_000):
    """Returns (n_records, n_dup_pairs).

    `data` may be bytes or an mmap — pass 1 extracts only the numeric
    key arrays (~100 B/record resident), pass 2 re-reads the mapped text
    in sorted batches and streams BGZF blocks to disk, so inputs larger
    than RAM sort within key-array memory (the role of the reference's
    LZ4 spill files, sortmardup/tbb/BAMRecordBuffer.cpp, is played by
    the page cache)."""
    if isinstance(data, (bytes, bytearray)):
        buf = data
    else:
        import ctypes
        buf = (ctypes.c_char * len(data)).from_buffer(data)
    parsed = native.parse_sam_numeric(buf, _count_lines(data) + 1)
    rid, pair_id = native.assign_rid_pairid(buf, parsed, header.names)
    return _native_pass2(buf, parsed, rid, pair_id, header, out_bam_path,
                         compress_level, device, batch_records)


def _native_pass2(buf, parsed, rid, pair_id, header: SamHeader,
                  out_bam_path, compress_level: int, device,
                  batch_records: int = 200_000):
    """Dup detection + coordinate sort + sorted-batch encode/BGZF/BAI
    over already-parsed numeric arrays (offsets index into `buf`)."""
    n = len(rid)
    kt = header.ktable()
    ref_len = int(kt[-1])
    pos0 = parsed["pos"] - 1
    ucoord = np.where(rid >= 0, kt[np.maximum(rid, 0)] + pos0, ref_len)
    rev = (parsed["flag"] & FREVERSE) != 0
    has_cig = parsed["ref_len"] > 0
    prime5 = np.where(
        rev & has_cig,
        ucoord + parsed["ref_len"] + parsed["tail_clip"] - 1,
        ucoord - np.where(~rev, parsed["lead_clip"], 0))

    with PROF.phase("SD_DUPSCAN"):
        dup_pids = _dup_pids(prime5, parsed["flag"], parsed["score"],
                             parsed["tile"], parsed["tx"], parsed["ty"],
                             pair_id, ref_len, device) if n \
            else np.zeros(0, np.int64)
        is_dup = np.isin(pair_id, dup_pids) if n else np.zeros(0, bool)
    with PROF.phase("SD_SORT"):
        order = _sort_order_np(ucoord, device) if n \
            else np.zeros(0, np.int64)
    flags_out = np.where(is_dup, parsed["flag"] | FDUP,
                         parsed["flag"]).astype(np.int32)

    # pass 2: encode + compress + index in sorted batches
    hdr = _sorted_header_bytes(header)
    bai = bamio.BaiBuilder(len(header.names))
    u_off = 0     # uncompressed stream offset
    c_off = 0     # compressed stream offset
    with open(out_bam_path, "wb") as fo:
        pending = hdr
        for lo in range(0, max(n, 1), batch_records):
            sel = order[lo:lo + batch_records]
            with PROF.phase("SD_ENCODE"):
                if len(sel):
                    recs, rec_off, erid, epos, erlen = \
                        native.encode_bam_records(
                            buf, parsed["line_start"][sel],
                            parsed["line_end"][sel], flags_out[sel],
                            header.names)
                else:
                    recs, rec_off, erid = b"", np.zeros(1, np.int64), []
            payload = pending + recs
            base = u_off + len(pending)
            with PROF.phase("SD_BGZF"):
                comp, table = bgzf.compress_stream(payload,
                                                   compress_level)
            with PROF.phase("SD_BAI"):
                vmap = bgzf.VirtualOffsetMap(
                    [(u + u_off, c, ul) for (u, c, ul) in table],
                    base_coff=c_off)
                voffs = vmap.voffsets(base +
                                      np.asarray(rec_off, np.int64))
                if len(erid):
                    erid = np.asarray(erid, np.int64)
                    epos = np.asarray(epos, np.int64)
                    erlen = np.asarray(erlen, np.int64)
                    bai.add_batch(erid, epos, epos + erlen,
                                  voffs[:-1], voffs[1:])
            fo.write(comp)
            u_off += len(payload)
            c_off += len(comp)
            pending = b""
        fo.write(bgzf.EOF_BLOCK)
    with open(str(out_bam_path) + ".bai", "wb") as fo:
        fo.write(bai.tobytes())
    return n, len(dup_pids)


def _count_lines(data) -> int:
    if isinstance(data, (bytes, bytearray)):
        return data.count(b"\n")
    n = 0
    CH = 1 << 24
    for i in range(0, len(data), CH):
        n += data[i:i + CH].count(b"\n")
    return n


def sort_markdup_file(path, out_bam_path, compress_level: int = 6,
                      device=None):
    """Streaming sormadup over a SAM file on disk (mmap-backed). Returns
    (n_records, n_dup_pairs)."""
    import mmap

    dev = resolve_device(device)
    with open(path, "rb") as f:
        header_lines = []
        while True:
            ln = f.readline()
            if not ln.startswith(b"@"):
                break
            header_lines.append(ln.decode().rstrip("\n"))
        header = SamHeader.parse(header_lines)
        # ACCESS_COPY: ctypes.from_buffer needs a writable view; pages
        # stay file-backed copy-on-write and are never written
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
            return _sort_markdup_native(mm, header, out_bam_path,
                                        compress_level, dev)


def sort_markdup(sam_lines, out_bam_path, compress_level: int = 6,
                 device=None):
    """Full sormadup: SAM text lines -> sorted BAM + .bai on disk.
    Returns (n_records, n_dup_pairs)."""
    dev = resolve_device(device)
    header = SamHeader.parse([ln for ln in sam_lines if ln.startswith("@")])
    data = "\n".join(ln.rstrip("\n") for ln in sam_lines).encode() + b"\n"
    return _sort_markdup_native(data, header, out_bam_path, compress_level,
                                dev)
