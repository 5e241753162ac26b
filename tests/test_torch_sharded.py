"""The port's contig-sharded aligner (parallel/sharded_index.py) against
the JAX package's and the port's joint Aligner: the contig partition and
the reference slices, the merge of per-shard regs into global
coordinates against fgdp_tpu's ShardedAligner._device_regs fed the same
per-shard regs (no JAX program runs), and ShardedAligner's SE and PE SAM
equal to the joint Aligner's on two random contigs, which share no
seed-length repeat, on the CPU."""

import numpy as np
import pytest

from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.parallel import sharded_index as jsi
from fgdp_tpu_torch.config import BatchShapes
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.parallel import sharded_index as si
from fgdp_tpu_torch.pipeline import Aligner

from test_torch_cuda import two_contigs
from test_torch_seeding import one_torch_thread  # noqa: F401

L = 101


@pytest.mark.parametrize("lens,n", [
    ([100, 100, 300, 100, 400], 1), ([100, 100, 300, 100, 400], 2),
    ([100, 100, 300, 100, 400], 3), ([100, 100, 300, 100, 400], 10),
    ([5000], 4), ([10, 20, 30, 40, 50, 60, 70], 4), ([900, 1, 1, 1], 3)])
def test_partition_contigs_equals_jax(lens, n):
    assert si.partition_contigs(lens, n) == jsi.partition_contigs(lens, n)


def _prefs(seed, lens):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 5, n).astype(np.uint8) for n in lens]
    names = [f"c{i}" for i in range(len(lens))]
    return (PackedReference.from_contigs(names, seqs),
            JPackedReference.from_contigs(names, seqs))


def test_slice_reference_equals_jax():
    ours, theirs = _prefs(0, (500, 700, 300, 900))
    np.testing.assert_array_equal(ours.codes, theirs.codes)
    for lo, hi in ((0, 1), (1, 2), (1, 4), (0, 4), (3, 4)):
        a = si.slice_reference(ours, lo, hi)
        b = jsi.slice_reference(theirs, lo, hi)
        assert a.names == b.names and a.l_pac == b.l_pac
        for f in ("lens", "offsets", "codes", "amb_offsets", "amb_lens",
                  "is_alt"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _shard_regs(rng, B, E, l_s, n_rid):
    """Regs in a shard's coordinates, as Aligner._regs_to_np gives them."""
    valid = rng.random((B, E)) < 0.6
    rb = rng.integers(0, 2 * l_s - 200, (B, E)).astype(np.int32)
    i32 = lambda hi: rng.integers(0, hi, (B, E)).astype(np.int32)
    return dict(rid=np.where(valid, i32(n_rid), -1), rb=rb,
                re=rb + i32(150), qb=i32(50), qe=50 + i32(100),
                score=i32(150), truesc=i32(150), sw_w=i32(100),
                seedcov=i32(100), seedlen0=i32(100), valid=valid,
                overflow=rng.random(B) < 0.1, ovf_seed=rng.random(B) < 0.1,
                frac_rep=rng.random(B).astype(np.float32))


def test_merge_equals_jax():
    ours, theirs = _prefs(1, (3000, 5000, 2000, 4000, 1000))
    groups = si.partition_contigs(ours.lens, 3)
    rng = np.random.default_rng(2)
    subs = [si.slice_reference(ours, lo, hi) for lo, hi in groups]
    regs = [_shard_regs(rng, 16, 5 + i, sp.l_pac, hi - lo)
            for i, (sp, (lo, hi)) in enumerate(zip(subs, groups))]

    class Shard:
        """Stands in for a JAX Aligner: hands back the given regs."""

        def __init__(self, sp, r):
            self.pref, self.r = sp, r

        def _device_regs_async(self, seq_codes):
            return None

        def _regs_to_np(self, fut, seq_codes):
            return self.r

    jsh = jsi.ShardedAligner.__new__(jsi.ShardedAligner)
    jsh.pref, jsh.groups = theirs, groups
    jsh.shards = [Shard(jsi.slice_reference(theirs, lo, hi), r)
                  for (lo, hi), r in zip(groups, regs)]
    want = jsh._device_regs(None)
    got = si.merge_shard_regs(ours, groups, [sp.l_pac for sp in subs],
                              regs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["rb"].dtype == np.int64 and got["valid"].shape == (16, 18)


@pytest.fixture(scope="module")
def aligners():
    pref, reads = two_contigs(20_000, 30_000, L)
    shapes = BatchShapes(read_len=L, batch_reads=64)
    joint = Aligner(pref, FMIndex.build(pref.codes), shapes=shapes,
                    device="cpu")
    sharded = si.ShardedAligner(pref, n_shards=2, shapes=shapes,
                                device="cpu")
    assert [sh.pref.names for sh in sharded.shards] == [["chrA"], ["chrB"]]
    return joint, sharded, reads(64)


def test_sharded_se_equals_joint(aligners):
    joint, sharded, (names, seqs) = aligners
    got = sharded.align_batch(names, seqs)
    assert got == joint.align_batch(names, seqs)
    assert sum(ln.split("\t")[2] == "chrB" for ln in got) >= 25
    assert sharded.sam_header() == joint.sam_header()


def test_sharded_pe_equals_joint(aligners):
    joint, sharded, (names, seqs) = aligners
    names = [f"p{i // 2}" for i in range(len(names))]   # ends on both
    assert sharded.align_pairs(names, seqs) == \
        joint.align_pairs(names, seqs)


def test_sharded_aligner_refuses_shards_above_int32(monkeypatch):
    pref, _ = two_contigs(500, 600, L)
    monkeypatch.setattr(PackedReference, "l_pac", property(
        lambda self: 2**30 + int(self.offsets[-1])))
    with pytest.raises(ValueError, match="int32"):
        si.ShardedAligner(pref, n_shards=2, device="cpu")
