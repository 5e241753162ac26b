"""The human-scale sharded run (fgdp_tpu_torch.bigindex_run) against
fgdp_tpu on the CPU: gen_contig draws as scripts/bigindex_run.py's does;
a small run's worker-built shard indexes equal in-process builds of both
packages, its plants on both strands align at their exact positions and
its SAM equals fgdp_tpu's ShardedAligner(lcp=False, shard_fms=...)'s;
and shard regs merged past 2^31 on the 10 x 128 Mb layout (a reference
of zeros whose untouched pages never become resident) equal fgdp_tpu's
merge and finalize."""

import importlib.util
import os
import resource
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu.config import BatchShapes as JBatchShapes
from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.parallel import sharded_index as jsi
from fgdp_tpu.pipeline import finalize_se_batch as j_finalize_se_batch
from fgdp_tpu_torch import bigindex_run as bir
from fgdp_tpu_torch.config import AlignConfig, BatchShapes
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.parallel.sharded_index import merge_shard_regs
from fgdp_tpu_torch.pipeline import finalize_se_batch

from test_torch_index import FM_FIELDS, _eq_fields
from test_torch_seeding import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = bir.L


def _script():
    spec = importlib.util.spec_from_file_location(
        "bigindex_run_script", os.path.join(ROOT, "scripts",
                                            "bigindex_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,n", [(42, 300_000), (3, 100_301)])
def test_gen_contig_equals_script(seed, n):
    want = _script().gen_contig(np.random.default_rng(seed), n)
    got = bir.gen_contig(np.random.default_rng(seed), n)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def small_run():
    torch.set_num_threads(1)
    # no timed batch: a batch's ladder rungs (128 reads a bucket) take
    # minutes of torch-op loops on the CPU
    return bir.run(3, 60_000, 2, "cpu", small=True, batch=0,
                   log=lambda m: None)


def test_small_run_shards_equal_in_process_builds(small_run):
    pref, fms = small_run["pref"], small_run["fms"]
    assert len(fms) == 3 and len(small_run["build_s"]) == 3
    for i, fm in enumerate(fms):
        codes = pref.codes[int(pref.offsets[i]):int(pref.offsets[i + 1])]
        _eq_fields(fm, FMIndex.build(codes), FM_FIELDS)
        _eq_fields(fm, JFMIndex.build(codes), FM_FIELDS)


def test_small_run_plants_exact_and_sam_equals_jax(small_run):
    pref = small_run["pref"]
    names, reads = small_run["plant_names"], small_run["plant_reads"]
    seqs = [pref.codes[int(o):int(o) + int(n)]
            for o, n in zip(pref.offsets, pref.lens)]
    _, _, truth = bir.plant_reads(seqs)
    assert sum(t[2] for t in truth) == bir.PLANTS      # both strands
    assert bir.misplaced(pref, small_run["plant_lines"], names, truth,
                         tol=0) == []
    jpref = JPackedReference.from_contigs(pref.names, seqs)
    jfms = [JFMIndex.build(s) for s in seqs]
    theirs = jsi.ShardedAligner(
        jpref, n_shards=3, lcp=False, shard_fms=jfms,
        shapes=JBatchShapes(read_len=L, batch_reads=2 * bir.PLANTS))
    assert theirs.align_batch(names, reads) == small_run["plant_lines"]


# ---- the merge and the finalize past 2^31, with no large index ----

N_CONTIGS, CONTIG = 10, 128_000_000
# (contig, 0-based position, reverse): a forward read of c9, a reverse
# complement of c0 (merged rb past 2^31), and the other strand of each
MERGE_PLANTS = [(9, 127_000_000, False), (0, 1_000_000, True),
                (0, 64_000_000, False), (9, 5_000_000, True)]


def _layout(cls, codes):
    """The 10 x 128 Mb PackedReference of bigindex_run, over `codes`."""
    lens = np.full(N_CONTIGS, CONTIG, np.int64)
    offsets = np.zeros(N_CONTIGS + 1, np.int64)
    offsets[1:] = np.cumsum(lens)
    return cls(names=[f"c{i}" for i in range(N_CONTIGS)], lens=lens,
               offsets=offsets, codes=codes,
               amb_offsets=np.zeros(0, np.int64),
               amb_lens=np.zeros(0, np.int64),
               is_alt=np.zeros(N_CONTIGS, bool))


def _shard_regs(s, B, E=2):
    """Shard s's regs (shard coordinates, int32, as _regs_to_np gives
    them): one full-length hit for each plant of its contig."""
    z = lambda: np.zeros((B, E), np.int32)
    regs = {f: z() for f in ("rid", "rb", "re", "qb", "qe", "score",
                             "truesc", "sw_w", "seedcov", "seedlen0")}
    regs.update(valid=np.zeros((B, E), bool),
                overflow=np.zeros(B, bool), ovf_seed=np.zeros(B, bool),
                frac_rep=np.zeros(B, np.float32))
    for b, (c, p, rev) in enumerate(MERGE_PLANTS):
        if c != s:
            continue
        rb = 2 * CONTIG - p - L if rev else p
        for f, v in dict(rid=0, rb=rb, re=rb + L, qb=0, qe=L, score=L,
                         truesc=L, sw_w=5, seedcov=L, seedlen0=L).items():
            regs[f][b, 0] = v
        regs["valid"][b, 0] = True
    return regs


class _StubShard:
    def __init__(self, s, B):
        self.s, self.B = s, B
        self.pref = SimpleNamespace(l_pac=CONTIG)

    def _device_regs_async(self, seq_codes):
        return self.s

    def _regs_to_np(self, s, seq_codes):
        return _shard_regs(s, self.B)


def test_merge_and_finalize_past_2_31():
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    codes = np.zeros(N_CONTIGS * CONTIG, np.uint8)   # pages not resident
    pref = _layout(PackedReference, codes)
    jpref = _layout(JPackedReference, codes)
    B = len(MERGE_PLANTS)
    groups = [(s, s + 1) for s in range(N_CONTIGS)]
    got = merge_shard_regs(pref, groups, [CONTIG] * N_CONTIGS,
                           [_shard_regs(s, B) for s in range(N_CONTIGS)])
    stub = SimpleNamespace(
        pref=jpref, groups=groups,
        shards=[_StubShard(s, B) for s in range(N_CONTIGS)])
    want = jsi.ShardedAligner._device_regs(stub, [None] * B)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["rb"].dtype == got["re"].dtype == np.int64
    assert want["rb"].dtype == np.int64
    # each plant's slot: its shard's slot 0, shards concatenated
    rb = [int(got["rb"][b, 2 * c]) for b, (c, _, _) in
          enumerate(MERGE_PLANTS)]
    re = [int(got["re"][b, 2 * c]) for b, (c, _, _) in
          enumerate(MERGE_PLANTS)]
    assert rb[1] > 2**31 and rb[0] < 2**31
    for (c, p, rev), b, e in zip(MERGE_PLANTS, rb, re):
        pos, is_rev = pref.depos(e - 1 if rev else b)
        assert is_rev == rev and pos - int(pref.offsets[c]) == p
    # real windows at the plants, then both finalizes on the merged regs
    rng = np.random.default_rng(16)
    reads = []
    for c, p, rev in MERGE_PLANTS:
        at = int(pref.offsets[c]) + p
        codes[at:at + L] = rng.integers(0, 4, L)
        w = codes[at:at + L].astype(np.int64)
        reads.append(3 - w[::-1] if rev else w)
    names = [f"m{b}" for b in range(B)]
    lines = finalize_se_batch(pref, AlignConfig(), BatchShapes(), names,
                              reads, None, got, 0)
    assert lines == j_finalize_se_batch(jpref, JAlignConfig(),
                                        JBatchShapes(), names, reads,
                                        None, want, 0)
    truth = [(c, p, rev) for c, p, rev in MERGE_PLANTS]
    assert bir.misplaced(pref, lines, names, truth, tol=0) == []
    # the finalize read the windows, not the whole 1.28 GB of codes
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    assert grown < 2**20, f"peak RSS grew {grown} KiB"


def test_bigindex_run_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bir.main(["--contigs", "1", "--mb", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bir.run(1, 10_000, 1, small=True)
    with pytest.raises(ValueError, match="2\\^31"):
        bir.run(2, 1_000_000, 1, device="cpu")
