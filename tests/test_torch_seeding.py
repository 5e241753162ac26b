"""collect_seeds of the port against fgdp_tpu's on the golden references.

Same reads through both packages; every SeedBatch field must be exactly
equal (tolerance 0), including a tiny-cap case that forces overflow."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.align import seeding as jseeding
from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.index.lcptree import LcpTree as JLcpTree
from fgdp_tpu.index.reference import DeviceReference as JDeviceReference
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.ops import fm as jfm
from fgdp_tpu.utils import dna as jdna
from fgdp_tpu_torch.align import seeding
from fgdp_tpu_torch.config import AlignConfig
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.lcptree import LcpTree
from fgdp_tpu_torch.index.reference import DeviceReference, PackedReference
from fgdp_tpu_torch.io.fastq import parse_fastq_records
from fgdp_tpu_torch.ops import fm
from fgdp_tpu_torch.utils import dna

HERE = os.path.join(os.path.dirname(__file__), "golden")
L = 100
# for the port's CLI run in a subprocess (see one_torch_thread)
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU path is many small torch ops. With the test workers
    side by side, torch's default pool of one thread per core in each
    worker oversubscribes the cores many times over and slows the runs
    by an order of magnitude, so each test runs torch on one thread.
    The other port test files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_both(ref_name):
    """(jax context, torch context) for one golden reference."""
    path = os.path.join(HERE, ref_name)
    jpref = JPackedReference.from_fasta(path)
    pref = PackedReference.from_fasta(path)
    jf = JFMIndex.build(jpref.codes)
    tf = FMIndex.build(pref.codes)
    x = np.concatenate([pref.codes, dna.revcomp(pref.codes)]) \
        .astype(np.uint8)
    jl = JLcpTree.build(np.concatenate(
        [jpref.codes, jdna.revcomp(jpref.codes)]).astype(np.uint8), jf.sa)
    tl = LcpTree.build(x, tf.sa)
    j = dict(pref=jpref, dfm=jfm.DeviceFMIndex.from_host(jf),
             dref=JDeviceReference(jpref), tree=jnp.asarray(jl.tree),
             isa=jnp.asarray(jl.isa))
    t = dict(pref=pref, dfm=fm.DeviceFMIndex.from_host(tf, device="cpu"),
             dref=DeviceReference(pref, device="cpu"), tree=torch.as_tensor(tl.tree),
             isa=torch.as_tensor(tl.isa))
    return j, t


def read_codes(fq_name, n=None):
    seqs = [dna.encode(r[2]) for r in
            parse_fastq_records(os.path.join(HERE, fq_name))][:n]
    codes = np.full((len(seqs), L), 4, np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, :min(len(s), L)] = s[:L]
        lens[i] = min(len(s), L)
    return codes, lens


def _eq_batch(jb, tb):
    for f in jb._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                      getattr(tb, f).cpu().numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("ref,fq,max_seeds", [
    ("ref.fa", "se.fq", 128),
    ("rep_ref.fa", "rep.fq", 128),
    ("rep_ref.fa", "rep.fq", 2),         # tiny caps: forces overflow
])
def test_collect_seeds_equal(ref, fq, max_seeds):
    j, t = build_both(ref)
    codes, lens = read_codes(fq, 64)
    active = np.ones(len(lens), bool)
    kw = dict(max_seeds=max_seeds, prev_cap=20, scale=1)
    jfn = jax.jit(functools.partial(jseeding.collect_seeds,
                                    opt=JAlignConfig(), **kw))
    jb = jfn(j["dfm"], j["dref"], jnp.asarray(codes), jnp.asarray(lens),
             jnp.asarray(active), lcp_tree=j["tree"], lcp_isa=j["isa"])
    tb = seeding.collect_seeds(
        t["dfm"], t["dref"], torch.as_tensor(codes),
        torch.as_tensor(lens), torch.as_tensor(active), AlignConfig(),
        lcp_tree=t["tree"], lcp_isa=t["isa"], **kw)
    _eq_batch(jb, tb)
    if max_seeds == 2:
        assert bool(tb.overflow.any())
