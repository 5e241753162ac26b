"""The contig-sharded aligner on the sweep engine: ShardedAligner(lcp=
False), the layout for a reference whose LCP trees do not fit the card,
as fgdp_tpu's scripts/bigindex_run.py builds it. On
tests/test_sharded_index.py's two random contigs at 20 + 30 kb, on the
CPU: the port's SAM (single-end and paired) equals fgdp_tpu's
ShardedAligner(lcp=False)'s, and the port's shards build no LCP tree
(lcp=True, the default, still builds one a shard)."""

import numpy as np
import pytest

from fgdp_tpu.config import BatchShapes as JBatchShapes
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.parallel import sharded_index as jsi
from fgdp_tpu_torch.config import BatchShapes
from fgdp_tpu_torch.parallel import sharded_index as si

from test_torch_cuda import two_contigs
from test_torch_seeding import one_torch_thread  # noqa: F401

L = 101


@pytest.fixture(scope="module")
def both_sweep():
    pref, reads = two_contigs(20_000, 30_000, L)
    jpref = JPackedReference.from_contigs(
        pref.names, [pref.codes[int(o):int(o) + int(n)]
                     for o, n in zip(pref.offsets, pref.lens)])
    ours = si.ShardedAligner(pref, n_shards=2, lcp=False,
                             shapes=BatchShapes(read_len=L, batch_reads=32),
                             device="cpu")
    theirs = jsi.ShardedAligner(
        jpref, n_shards=2, lcp=False,
        shapes=JBatchShapes(read_len=L, batch_reads=32))
    return ours, theirs, reads(32)


def test_sharded_sweep_builds_no_lcp_tree(both_sweep):
    ours, _, _ = both_sweep
    assert len(ours.shards) == 2
    assert all(sh.lcp_tree is None and sh.lcp_isa is None
               for sh in ours.shards)
    pref, _ = two_contigs(2_000, 3_000, L)
    default = si.ShardedAligner(pref, n_shards=2, device="cpu")
    assert all(sh.lcp_tree is not None for sh in default.shards)


def test_sharded_sweep_se_equals_jax(both_sweep):
    ours, theirs, (names, seqs) = both_sweep
    np.testing.assert_array_equal(ours.pref.codes, theirs.pref.codes)
    got = ours.align_batch(names, seqs)
    assert got == theirs.align_batch(names, seqs)
    assert sum(ln.split("\t")[2] == "chrB" for ln in got) >= 12


def test_sharded_sweep_pe_equals_jax(both_sweep):
    ours, theirs, (names, seqs) = both_sweep
    names = [f"p{i // 2}" for i in range(len(names))]
    assert ours.align_pairs(names, seqs) == theirs.align_pairs(names, seqs)
