"""ctypes loader for the native host runtime (native/fgdp_native.cc).

The port builds its own copy of the library on first use (g++ -O3
-shared) into build/fgdp_tpu_torch/ at the repository root, never into
native/, and binds the functions the port calls: parse_fastq_chunk,
suffix_array_u8, lcp_tree_arrays and ksw_global_batch_native for
alignment; parse_sam_numeric, assign_rid_pairid, encode_bam_records and
bgzf_compress_parallel for the sort. The library is required: a failed
build or load raises, and so does a call that the library refuses (the
JAX package falls back to Python there), so every run measures the same
host code.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_ROOT, "native", "fgdp_native.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "fgdp_tpu_torch")
_SO = os.path.join(BUILD_DIR, "fgdp_native.so")

_lib = None


def _build():
    """Compile into a temporary name, then rename: concurrent test
    workers may race to build, and a rename is atomic."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC, "-lz",
             "-lpthread"],
            check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded library, built first when missing or stale. Raises
    RuntimeError with the compiler's output when g++ fails."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        try:
            _build()
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"building {_SRC} failed:\n{e.stderr.decode()}") from e
    lib = ctypes.CDLL(_SO)
    lib.parse_fastq_chunk.restype = ctypes.c_long
    lib.suffix_array_u8.restype = ctypes.c_int64
    lib.ksw_global_batch_native.restype = ctypes.c_int
    lib.lcp_tree_arrays.restype = ctypes.c_int
    lib.parse_sam_numeric.restype = ctypes.c_long
    lib.assign_rid_pairid.restype = None
    lib.encode_bam_records.restype = ctypes.c_int64
    lib.bgzf_compress_parallel.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def parse_fastq_chunk(data: bytes, max_reads: int, max_len: int,
                      name_cap: int = 128):
    """Returns (names, codes u8[B,L], quals u8[B,L], lens i32[B],
    consumed)."""
    lib = get_lib()
    codes = np.empty((max_reads, max_len), np.uint8)
    quals = np.empty((max_reads, max_len), np.uint8)
    lens = np.zeros(max_reads, np.int32)
    names = np.zeros((max_reads, name_cap), np.uint8)
    consumed = ctypes.c_long(0)
    n = lib.parse_fastq_chunk(
        data, ctypes.c_long(len(data)), ctypes.c_long(max_reads),
        ctypes.c_long(max_len), _ptr(codes, ctypes.c_ubyte),
        _ptr(quals, ctypes.c_ubyte), _ptr(lens, ctypes.c_int32),
        _ptr(names, ctypes.c_char), ctypes.c_long(name_cap),
        ctypes.byref(consumed))
    name_list = [bytes(names[i]).rstrip(b"\0").decode()
                 for i in range(n)]
    return (name_list, codes[:n], quals[:n], lens[:n], consumed.value)


def parse_sam_numeric(data: bytes, max_recs: int):
    """Returns dict of numeric per-record arrays + line/column offsets."""
    lib = get_lib()
    i32 = lambda: np.zeros(max_recs, np.int32)
    i64 = lambda: np.zeros(max_recs, np.int64)
    out = dict(flag=i32(), pos=i64(), mapq=i32(), lead_clip=i32(),
               tail_clip=i32(), ref_len=i32(), score=i32(), tile=i32(),
               tx=i32(), ty=i32(), line_start=i64(), line_end=i64(),
               qn_start=i64(), qn_end=i64(), rn_start=i64(), rn_end=i64())
    n = lib.parse_sam_numeric(
        data, ctypes.c_long(len(data)), ctypes.c_long(max_recs),
        _ptr(out["flag"], ctypes.c_int32), _ptr(out["pos"], ctypes.c_int64),
        _ptr(out["mapq"], ctypes.c_int32),
        _ptr(out["lead_clip"], ctypes.c_int32),
        _ptr(out["tail_clip"], ctypes.c_int32),
        _ptr(out["ref_len"], ctypes.c_int32),
        _ptr(out["score"], ctypes.c_int32),
        _ptr(out["tile"], ctypes.c_int32), _ptr(out["tx"], ctypes.c_int32),
        _ptr(out["ty"], ctypes.c_int32),
        _ptr(out["line_start"], ctypes.c_int64),
        _ptr(out["line_end"], ctypes.c_int64),
        _ptr(out["qn_start"], ctypes.c_int64),
        _ptr(out["qn_end"], ctypes.c_int64),
        _ptr(out["rn_start"], ctypes.c_int64),
        _ptr(out["rn_end"], ctypes.c_int64))
    return {k: v[:n] for k, v in out.items()}


def _name_table(names):
    """Concatenated NUL-separated contig names + int32 offsets."""
    offs = np.zeros(max(len(names), 1), np.int32)
    blob = bytearray()
    for i, nm in enumerate(names):
        offs[i] = len(blob)
        blob += nm.encode() + b"\0"
    return bytes(blob), offs


def assign_rid_pairid(data: bytes, parsed: dict, names):
    """rid + pair_id for records from parse_sam_numeric (BamParser
    pop_record pairing, sortmardup/tbb/bam_parser.cpp:76-128).
    Returns (rid int32[n], pair_id int64[n])."""
    lib = get_lib()
    n = len(parsed["flag"])
    blob, offs = _name_table(names)
    rid = np.zeros(n, np.int32)
    pair_id = np.zeros(n, np.int64)
    lib.assign_rid_pairid(
        data, ctypes.c_long(n),
        _ptr(parsed["qn_start"], ctypes.c_int64),
        _ptr(parsed["qn_end"], ctypes.c_int64),
        _ptr(parsed["rn_start"], ctypes.c_int64),
        _ptr(parsed["rn_end"], ctypes.c_int64),
        _ptr(parsed["flag"], ctypes.c_int32),
        blob, _ptr(offs, ctypes.c_int32), ctypes.c_long(len(names)),
        _ptr(rid, ctypes.c_int32), _ptr(pair_id, ctypes.c_int64))
    return rid, pair_id


def encode_bam_records(data: bytes, line_start, line_end, flag_override,
                       names):
    """Encode SAM lines (in the given order) to concatenated raw BAM
    records. Returns (payload bytes, rec_off int64[n+1], rid int32[n],
    pos int64[n], rlen int32[n]); raises on a line the encoder refuses
    (fewer than 11 columns, an unknown CIGAR operation)."""
    lib = get_lib()
    n = len(line_start)
    line_start = np.ascontiguousarray(line_start, np.int64)
    line_end = np.ascontiguousarray(line_end, np.int64)
    flag_override = np.ascontiguousarray(flag_override, np.int32)
    blob, offs = _name_table(names)
    text_bytes = int((line_end - line_start).sum()) if n else 0
    cap = text_bytes + 256 * max(n, 1) + 1024
    out = np.empty(cap, np.uint8)
    rec_off = np.zeros(n + 1, np.int64)
    rid = np.zeros(n, np.int32)
    pos = np.zeros(n, np.int64)
    rlen = np.zeros(n, np.int32)
    w = lib.encode_bam_records(
        data, _ptr(line_start, ctypes.c_int64),
        _ptr(line_end, ctypes.c_int64),
        _ptr(flag_override, ctypes.c_int32), ctypes.c_long(n),
        blob, _ptr(offs, ctypes.c_int32), ctypes.c_long(len(names)),
        _ptr(out, ctypes.c_char), ctypes.c_int64(cap),
        _ptr(rec_off, ctypes.c_int64), _ptr(rid, ctypes.c_int32),
        _ptr(pos, ctypes.c_int64), _ptr(rlen, ctypes.c_int32))
    if w < 0:
        raise ValueError("encode_bam_records refused a SAM line (fewer "
                         "than 11 columns or a bad CIGAR)")
    return bytes(out[:w]), rec_off, rid, pos, rlen


def bgzf_compress(data: bytes, level: int = 6, threads: int = 8):
    """Parallel BGZF compression (native/fgdp_native.cc pthread pool).
    Returns (compressed bytes, block_table [(ustart, coff, ulen)]) with
    io/bgzf.compress_stream semantics."""
    lib = get_lib()
    MAX_BLOCK = 0xFF00
    n = len(data)
    n_blocks = max((n + MAX_BLOCK - 1) // MAX_BLOCK, 1)
    stride = 0x10000 + 64
    out = np.empty(n_blocks * stride, np.uint8)
    coff = np.zeros(n_blocks + 1, np.int64)
    w = lib.bgzf_compress_parallel(
        data, ctypes.c_int64(n), ctypes.c_int(level), ctypes.c_int(threads),
        _ptr(out, ctypes.c_char), ctypes.c_int64(stride),
        _ptr(coff, ctypes.c_int64))
    if w < 0:
        raise RuntimeError("bgzf_compress_parallel failed")
    table = [(b * MAX_BLOCK, int(coff[b]),
              min(n - b * MAX_BLOCK, MAX_BLOCK) if n else 0)
             for b in range(n_blocks)]
    return bytes(out[:w]), table


def ksw_global_batch(queries, qlens, targets, tlens, ws, o_del, e_del,
                     o_ins, e_ins, mat, nthreads: int | None = None,
                     max_cig: int = 96):
    """Batched banded global alignment with traceback (native
    transcription of align/finalize.ksw_global — reference ksw_global2,
    src/ksw.cpp). Returns (scores int64[N], cigars list[[(op, len)]]).
    Jobs whose cigar exceeds max_cig ops come back as None entries in
    the cigars list (the caller runs those through the scalar
    ksw_global)."""
    lib = get_lib()
    N = len(qlens)
    if N == 0:
        return np.zeros(0, np.int64), []
    qs = np.ascontiguousarray(queries, np.uint8)
    ts = np.ascontiguousarray(targets, np.uint8)
    ql = np.ascontiguousarray(qlens, np.int32)
    tl = np.ascontiguousarray(tlens, np.int32)
    wsa = np.ascontiguousarray(ws, np.int32)
    m8 = np.ascontiguousarray(np.asarray(mat).reshape(25), np.int8)
    scores = np.zeros(N, np.int32)
    cig = np.zeros((N, 2 * max_cig), np.int32)
    ncig = np.zeros(N, np.int32)
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    lib.ksw_global_batch_native(
        _ptr(qs, ctypes.c_ubyte), _ptr(ts, ctypes.c_ubyte),
        _ptr(ql, ctypes.c_int32), _ptr(tl, ctypes.c_int32),
        _ptr(wsa, ctypes.c_int32),
        ctypes.c_int64(N), ctypes.c_int64(qs.shape[1]),
        ctypes.c_int64(ts.shape[1]), _ptr(m8, ctypes.c_int8),
        ctypes.c_int(o_del), ctypes.c_int(e_del), ctypes.c_int(o_ins),
        ctypes.c_int(e_ins), ctypes.c_int(nthreads),
        _ptr(scores, ctypes.c_int32), _ptr(cig, ctypes.c_int32),
        _ptr(ncig, ctypes.c_int32), ctypes.c_int64(max_cig))
    cigars = []
    for j in range(N):
        nc = int(ncig[j])
        if nc < 0:
            cigars.append(None)
        else:
            row = cig[j, :2 * nc]
            cigars.append([(int(row[2 * i]), int(row[2 * i + 1]))
                           for i in range(nc)])
    return scores.astype(np.int64), cigars


def lcp_tree_arrays(x: np.ndarray, sa: np.ndarray):
    """Kasai LCP + prev/next-strictly-smaller boundary arrays for the
    single-pass SMEM engine (ops/smem_lcp.py). x uint8[xlen] codes,
    sa int32[xlen+1] full suffix array incl. the sentinel row. Returns
    (lcp, left, right) int32[xlen+2] per SA boundary."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.uint8)
    sa = np.ascontiguousarray(sa, np.int32)
    nrows = len(sa)
    lcp = np.zeros(nrows + 1, np.int32)
    left = np.zeros(nrows + 1, np.int32)
    right = np.zeros(nrows + 1, np.int32)
    rc = lib.lcp_tree_arrays(x.ctypes.data_as(ctypes.c_char_p),
                             ctypes.c_int64(len(x)),
                             _ptr(sa, ctypes.c_int32),
                             ctypes.c_int64(nrows),
                             _ptr(lcp, ctypes.c_int32),
                             _ptr(left, ctypes.c_int32),
                             _ptr(right, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"lcp_tree_arrays failed ({rc})")
    return lcp, left, right


def suffix_array_u8(codes: np.ndarray):
    """Linear-time SA-IS over uint8 codes (values below 255)."""
    lib = get_lib()
    s = np.ascontiguousarray(codes, np.uint8)
    sa = np.zeros(len(s), np.int64)
    n = lib.suffix_array_u8(s.ctypes.data_as(ctypes.c_char_p),
                            ctypes.c_int64(len(s)),
                            _ptr(sa, ctypes.c_int64))
    if n != len(s):
        raise RuntimeError(f"suffix_array_u8 returned {n} of {len(s)} rows")
    return sa
