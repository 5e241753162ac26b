"""The port's sort + duplicate marking + BAM writer (`sormadup`) on the
CPU against fgdp_tpu's, on the same SAM text.

Duplicate sets must be equal (and equal to the scalar oracle), and BAM
and BAI bytes identical. The inputs hold what decides which record of a
run is marked: full ties (names without tile:x:y, equal qualities),
negative 5' positions (reads soft-clipped at the start of the first
contig), secondary and unmapped records."""

import mmap
import os

import numpy as np
import pytest
import torch

from fgdp_tpu.io import bam as jbam
from fgdp_tpu.io import bgzf as jbgzf
from fgdp_tpu.io.sam import SamHeader as JSamHeader
from fgdp_tpu.io.sam import parse_sam_records as jparse_sam_records
from fgdp_tpu.sortdup import driver as jdriver
from fgdp_tpu.sortdup import engine as jengine
from fgdp_tpu.testing import oracles
from fgdp_tpu_torch import cli
from fgdp_tpu_torch.io import bam, bgzf
from fgdp_tpu_torch.io.sam import SamHeader, parse_sam_records
from fgdp_tpu_torch.sortdup import driver, engine

from test_torch_cuda import HEADER, _rec, random_sam
from test_torch_seeding import one_torch_thread  # noqa: F401


def _records(lines, parse, header_cls):
    header = header_cls.parse(HEADER)
    return parse(lines, header), int(header.ktable()[-1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_duplicates_matches_jax_and_oracle(seed):
    lines = random_sam(seed)
    recs, ref_len = _records(lines, parse_sam_records, SamHeader)
    jrecs, _ = _records(lines, jparse_sam_records, JSamHeader)
    got = driver.find_duplicates(recs, ref_len, device="cpu")
    assert got == jdriver.find_duplicates(jrecs, ref_len)
    assert got == oracles.mark_duplicates_ref(jrecs, ref_len)
    # the inputs hold what the test is for: duplicate pairs and singles
    pid = np.asarray(recs.pair_id)
    sizes = {int(p): int((pid == p).sum()) for p in got}
    assert sum(v == 2 for v in sizes.values()) > 5
    assert sum(v == 1 for v in sizes.values()) > 3
    assert (np.asarray(recs.prime5)[np.asarray(recs.pair_id) > 0] < 0).any()
    assert (np.asarray(recs.tile)[np.asarray(recs.pair_id) > 0] == 0).sum() \
        > 50


def test_engine_matches_jax_on_ties_and_negatives():
    """mark_duplicates and coordinate_sort_order on raw key arrays: heavy
    full ties, negative and 64-bit positions, invalid lanes in the
    middle (the JAX package pads only at the end; either must work)."""
    rng = np.random.default_rng(7)
    ND, NS = 300, 200
    L = 3_100_000_000            # a human-sized genome: keys above 2^32
    p5a = rng.choice([-7, -1, 0, 5, 2**31 + 3, L - 1], ND).astype(np.int64)
    p5b = p5a + rng.choice([0, 1, 150], ND)
    orient = rng.integers(0, 4, ND).astype(np.int32)
    score = rng.choice([0, 10], ND).astype(np.int32)
    tile, tx, ty = (rng.choice([0, 1], ND).astype(np.int32)
                    for _ in range(3))
    dvalid = rng.random(ND) < 0.9
    s_p5 = np.concatenate([p5a[:NS // 2], rng.choice(
        [-7, 5, 149, 2**31 + 3], NS - NS // 2)]).astype(np.int64)
    s_rev = rng.choice([0, 3], NS).astype(np.int32)
    s_score = rng.choice([0, 10], NS).astype(np.int32)
    s_tile, s_x, s_y = (rng.choice([0, 1], NS).astype(np.int32)
                        for _ in range(3))
    svalid = rng.random(NS) < 0.9

    t = torch.as_tensor
    got_d, got_s = engine.mark_duplicates(
        t(p5a), t(orient), t(p5b), t(score), t(tile), t(tx), t(ty),
        t(dvalid), t(s_p5), t(s_rev), t(s_score), t(s_tile), t(s_x),
        t(s_y), t(svalid), L)
    sp = jdriver._split_np
    want_d, want_s = jengine.mark_duplicates(
        *sp(p5a), orient, *sp(p5b), score, tile, tx, ty, dvalid,
        *sp(s_p5), s_rev, s_score, s_tile, s_x, s_y, svalid,
        *(np.int32(v) for v in sp(np.int64(L))))
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert 0 < got_d.sum() < dvalid.sum() and 0 < got_s.sum()

    uc = rng.choice([-3, 0, 7, 2**33], 500).astype(np.int64)
    valid = rng.random(500) < 0.8
    got = engine.coordinate_sort_order(t(uc), t(valid)).numpy()
    want = np.asarray(jengine.coordinate_sort_order(*sp(uc), valid))
    assert np.array_equal(got, want)


def _bam_pair(tmp_path, name):
    out = tmp_path / name
    return out, lambda: (out.read_bytes(),
                         (tmp_path / (name + ".bai")).read_bytes())


@pytest.mark.parametrize("seed", [3, 4])
def test_sort_markdup_bytes_equal_jax(seed, tmp_path):
    lines = HEADER + random_sam(seed, n_pairs=120, n_singles=40)
    ours, ours_bytes = _bam_pair(tmp_path, "port.bam")
    theirs, their_bytes = _bam_pair(tmp_path, "jax.bam")
    res = driver.sort_markdup(lines, ours, device="cpu")
    assert res == jdriver.sort_markdup(lines, theirs)
    assert res[1] > 5
    assert ours_bytes() == their_bytes()


@pytest.mark.parametrize("batch_records", [40, 97, 200_000])
def test_sort_markdup_file_bytes_equal_jax(batch_records, tmp_path):
    """The mmap-backed path, with several pass-2 batches where
    batch_records is small, writes the JAX package's bytes."""
    lines = HEADER + random_sam(5, n_pairs=100, n_singles=30)
    sam = tmp_path / "in.sam"
    sam.write_text("\n".join(lines) + "\n")
    ours, ours_bytes = _bam_pair(tmp_path, "port.bam")
    theirs, their_bytes = _bam_pair(tmp_path, "jax.bam")
    hdr = [ln for ln in lines if ln[0] == "@"]
    with open(sam, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
        res = driver._sort_markdup_native(mm, SamHeader.parse(hdr), ours, 6,
                                          "cpu", batch_records)
        assert res == jdriver._sort_markdup_native(
            mm, JSamHeader.parse(hdr), theirs, 6,
            batch_records=batch_records)
    assert ours_bytes() == their_bytes()
    if batch_records == 200_000:       # one batch: the file entry point
        assert driver.sort_markdup_file(sam, ours, device="cpu") == res
        assert ours_bytes() == their_bytes()


def test_sormadup_cli_matches_jax(tmp_path):
    lines = HEADER + random_sam(6, n_pairs=80, n_singles=20)
    sam = tmp_path / "in.sam"
    sam.write_text("\n".join(lines) + "\n")
    ours, ours_bytes = _bam_pair(tmp_path, "port.bam")
    theirs, their_bytes = _bam_pair(tmp_path, "jax.bam")
    cli.main(["sormadup", str(sam), str(ours), "--device", "cpu"])
    jdriver.sort_markdup_file(sam, theirs)
    assert ours_bytes() == their_bytes()
    _, names, _, recs = bam.read_bam(ours)
    assert names == ["chr1", "chr2"] and len(recs) == len(lines) - 3


def test_empty_input_matches_jax(tmp_path):
    ours, ours_bytes = _bam_pair(tmp_path, "port.bam")
    theirs, their_bytes = _bam_pair(tmp_path, "jax.bam")
    assert driver.sort_markdup(HEADER, ours, device="cpu") == (0, 0)
    jdriver.sort_markdup(HEADER, theirs)
    assert ours_bytes() == their_bytes()


def test_encode_record_matches_jax():
    name_to_rid = {"chr1": 0, "chr2": 1}
    lines = random_sam(8, n_pairs=10, n_singles=5) + [
        _rec("t1", 0, "chr2", 7, "3S4M2I1D5M=2X", seq="ACGTNRYACGTACGTA",
             qual="*", tags=("XA:Z:chr1,+5,10M,0;", "XI:i:-5",
                             "XU:i:4294967295", "XF:f:0.25", "XC:A:Q",
                             "XH:H:1AE3", "XB:B:c,-1,2", "XS:B:S,7,8,9",
                             "XJ:B:f,1.5")),
        _rec("t2", 4, "*", 0, "*", seq="*", qual="*")]
    for ln in lines:
        f = ln.split("\t")
        for fo in (None, 0x400):
            assert bam.encode_record(f, name_to_rid, fo) == \
                jbam.encode_record(f, name_to_rid, fo)
    assert bam.reg2bin(0, 1) == jbam.reg2bin(0, 1) == 4681
    hdr = "\n".join(HEADER) + "\n"
    assert bam.bam_header_bytes(hdr, ["chr1", "chr2"], [10000, 5000]) == \
        jbam.bam_header_bytes(hdr, ["chr1", "chr2"], [10000, 5000])


def test_bai_builder_matches_jax():
    """add() and add_batch() each write the JAX package's index, and the
    two agree with each other."""
    rng = np.random.default_rng(9)
    n = 3000
    rids = rng.integers(-1, 3, n).astype(np.int64)
    begs = rng.integers(0, 1 << 22, n).astype(np.int64)
    ends = begs + rng.integers(50, 50_000, n)
    order = np.lexsort((begs, rids))
    rids, begs, ends = rids[order], begs[order], ends[order]
    voffs = np.sort(rng.integers(0, 1 << 40, n + 1).astype(np.uint64))
    vb, ve = voffs[:-1], voffs[1:]
    built = []
    for mod in (bam, jbam):
        a, b = mod.BaiBuilder(3), mod.BaiBuilder(3)
        for i in range(n):
            a.add(int(rids[i]), int(begs[i]), int(ends[i]), int(vb[i]),
                  int(ve[i]))
        b.add_batch(rids, begs, ends, vb, ve)
        built += [a.tobytes(), b.tobytes()]
    assert len(set(built)) == 1


@pytest.mark.parametrize("size", [0, 1000, 0xFF00, 300_000])
def test_compress_stream_matches_jax(size):
    """Serial blocks below five blocks, the native parallel compressor
    above: the same bytes and block table as the JAX package's, and a
    stream that inflates back."""
    rng = np.random.default_rng(size)
    data = rng.integers(0, 4, size).astype(np.uint8).tobytes()
    got = bgzf.compress_stream(data)
    assert got == jbgzf.compress_stream(data)
    assert bgzf.decompress(got[0] + bgzf.EOF_BLOCK) == data
    assert bgzf.EOF_BLOCK == jbgzf.EOF_BLOCK
    vm, jvm = bgzf.VirtualOffsetMap(got[1], 7), \
        jbgzf.VirtualOffsetMap(got[1], 7)
    u = np.arange(0, max(size, 1), 997)
    assert np.array_equal(vm.voffsets(u), jvm.voffsets(u))
    assert [vm.voffset(int(x)) for x in u[:20]] == \
        [jvm.voffset(int(x)) for x in u[:20]]


def test_sort_requires_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.sort_markdup(HEADER, tmp_path / "x.bam")
    assert not os.path.exists(tmp_path / "x.bam")
