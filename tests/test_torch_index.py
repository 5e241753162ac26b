"""The port's index builders against fgdp_tpu's: SA, FM occ rows, LCP
tree/ISA and PackedReference are exactly equal, and each package loads
the other's .npz index files. The FASTQ readers (the native chunk parser
and the record reader) give the same batches as fgdp_tpu's."""

import os

import numpy as np
import pytest

from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.io import fastq as jfastq
from fgdp_tpu.index.lcptree import LcpTree as JLcpTree
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.index.suffix_array import suffix_array as j_suffix_array
from fgdp_tpu.utils import dna as jdna
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.lcptree import LcpTree
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.index.suffix_array import suffix_array
from fgdp_tpu_torch.io import fastq
from fgdp_tpu_torch.utils import dna

from test_torch_seeding import one_torch_thread  # noqa: F401

HERE = os.path.join(os.path.dirname(__file__), "golden")


def _random_contigs():
    rng = np.random.default_rng(20)
    seqs = [rng.integers(0, 4, 12_000).astype(np.uint8),
            rng.integers(0, 4, 8_000).astype(np.uint8)]
    seqs[0][500:520] = 4                  # an ambiguous run
    return seqs


def _refs(which):
    if which == "random20kb":
        seqs = _random_contigs()
        return (JPackedReference.from_contigs(["a", "b"], seqs),
                PackedReference.from_contigs(["a", "b"], seqs))
    path = os.path.join(HERE, which)
    return JPackedReference.from_fasta(path), PackedReference.from_fasta(path)


def _eq_fields(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


FM_FIELDS = ("counts", "c2", "occ", "occ2", "bwt_words", "bwt1_words", "sa",
             "sentinel_row", "r1_row", "cc_r0", "cc_r1", "n_ref",
             "text_len")
REF_FIELDS = ("names", "lens", "offsets", "codes", "amb_offsets",
              "amb_lens", "is_alt")


@pytest.mark.parametrize("which", ["random20kb", "ref.fa", "alt_ref.fa"])
def test_index_builders_equal(which):
    jp, tp = _refs(which)
    _eq_fields(jp, tp, REF_FIELDS)
    np.testing.assert_array_equal(j_suffix_array(jp.codes),
                                  suffix_array(tp.codes))
    jf, tf = JFMIndex.build(jp.codes), FMIndex.build(tp.codes)
    _eq_fields(jf, tf, FM_FIELDS)
    x = np.concatenate([tp.codes, dna.revcomp(tp.codes)]).astype(np.uint8)
    jx = np.concatenate([jp.codes, jdna.revcomp(jp.codes)]).astype(np.uint8)
    jl, tl = JLcpTree.build(jx, jf.sa), LcpTree.build(x, tf.sa)
    np.testing.assert_array_equal(jl.tree, tl.tree)
    np.testing.assert_array_equal(jl.isa, tl.isa)


def test_npz_files_load_across_packages(tmp_path):
    jp, tp = _refs("ref.fa")
    jf, tf = JFMIndex.build(jp.codes), FMIndex.build(tp.codes)
    x = np.concatenate([tp.codes, dna.revcomp(tp.codes)]).astype(np.uint8)
    tl = LcpTree.build(x, tf.sa)
    jl = JLcpTree.build(x, jf.sa)
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jp.save(a + ".ref"), jf.save(a + ".fmi"), jl.save(a + ".lcp")
    tp.save(b + ".ref"), tf.save(b + ".fmi"), tl.save(b + ".lcp")
    # each package reads the other's files
    _eq_fields(PackedReference.load(a + ".ref.npz"), jp, REF_FIELDS)
    _eq_fields(JPackedReference.load(b + ".ref.npz"), tp, REF_FIELDS)
    _eq_fields(FMIndex.load(a + ".fmi.npz"), jf, FM_FIELDS)
    _eq_fields(JFMIndex.load(b + ".fmi.npz"), tf, FM_FIELDS)
    np.testing.assert_array_equal(LcpTree.load(a + ".lcp.npz").tree,
                                  jl.tree)
    np.testing.assert_array_equal(JLcpTree.load(b + ".lcp.npz").isa,
                                  tl.isa)


@pytest.mark.parametrize("fq", ["se.fq", "rep.fq"])
def test_fastq_readers_equal(fq):
    path = os.path.join(HERE, fq)
    assert list(fastq.parse_fastq_records(path)) == \
        list(jfastq.parse_fastq_records(path))
    # small chunks: several batches, padded to a multiple of 16 rows
    kw = dict(read_len=151, chunk_bp=151 * 40, pad_multiple=16)
    got = list(fastq.read_batches(path, **kw))
    want = list(jfastq.read_batches(path, **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.names == w.names
        for f in ("codes", "quals", "lengths"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)


def _build_case(case):
    """(codes, chunk) of a lean-build case: text lengths 2n + 1 at the
    occ blocks' edges (2n + 1 is odd: 2n + 1 = 32k + 1 is the length whose
    2n text codes fill whole blocks, 32k + 31 the one a code short of
    them), one and two bases, N runs randomized by from_contigs, and
    small chunks so that a pass spans many of them."""
    rng = np.random.default_rng(31)
    n, chunk = {"n15": (15, None), "n16": (16, None), "n31": (31, None),
                "n32": (32, None), "n1024": (1024, None),
                "one_base": (1, None), "two_bases": (2, None),
                "chunks32": (3_000, 32), "chunks96": (3_001, 96),
                "n_runs": (5_000, 64)}[case]
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if case == "n_runs":
        codes[100:130] = 4
        codes[4_000:4_300] = 4
        codes[-7:] = 4
        codes = PackedReference.from_contigs(["c"], [codes]).codes
    return codes, chunk


@pytest.mark.parametrize("case", ["n15", "n16", "n31", "n32", "n1024",
                                  "one_base", "two_bases", "chunks32",
                                  "chunks96", "n_runs"])
def test_lean_fm_build_equals_jax(case):
    codes, chunk = _build_case(case)
    kw = {} if chunk is None else dict(chunk=chunk)
    got, want = FMIndex.build(codes, **kw), JFMIndex.build(codes)
    _eq_fields(got, want, FM_FIELDS)
    for f in FM_FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        assert type(x) is type(y), f
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
    if chunk is not None:
        assert got.text_len > 4 * chunk            # several chunks


def test_lean_fm_build_traced_peak():
    """The numpy peak of FMIndex.build (tracemalloc; the native SA-IS's
    own working memory is not traced) stays at most 32 B a text position
    on a 1 Mb genome."""
    import tracemalloc
    from fgdp_tpu_torch.io import native
    native.get_lib()
    codes = np.random.default_rng(5).integers(0, 4, 1_000_000) \
        .astype(np.uint8)
    tracemalloc.start()
    try:
        fm = FMIndex.build(codes)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak <= 32 * fm.text_len, peak / fm.text_len
