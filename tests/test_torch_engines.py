"""The port's fallback seeding engines through collect_seeds and the
Aligner, against fgdp_tpu's and against the port's LCP engine.

  * collect_seeds with lcp_tree=None (sweep K1 + sweep K2), with
    use_sweep=False (wave K1 + wave K2) and with an LCP tree under
    FGDP_K2_SWEEP=1 (LCP K1 + sweep K2) equals fgdp_tpu's collect_seeds
    with the same arguments, every SeedBatch field exactly (tolerance 0),
    at default caps, at the escalation ladder's scale and at caps small
    enough to overflow;
  * Aligner(lcp=False) and Aligner(lcp=None) seed through the sweep,
    Aligner() through the LCP tree, as in fgdp_tpu;
  * Aligner(lcp=False)'s SAM equals the LCP Aligner's on
    tests/golden/rep.fq for every read neither leaves overflowed.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.align import seeding as jseeding
from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu_torch.align import seeding
from fgdp_tpu_torch.config import AlignConfig

from test_torch_seeding import one_torch_thread  # noqa: F401
from test_torch_seeding import _eq_batch, build_both, read_codes

ENGINES = {
    # name: (collect_seeds keywords, LCP tree given, FGDP_K2_SWEEP)
    "sweep": (dict(), False, None),
    "wave": (dict(use_sweep=False), False, None),
    "lcp_k2_sweep": (dict(), True, "1"),
}
CAPS = {
    # name: (max_seeds, scale, k2_scale)
    "default": (128, 1, 0),
    "ladder_k2w": (128, 1, 2),
    "tiny": (2, 1, 0),
}


@pytest.fixture(scope="module")
def rep():
    j, t = build_both("rep_ref.fa")
    codes, lens = read_codes("rep.fq", 64)
    return j, t, codes, lens


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_collect_seeds_engine_equal_jax(rep, monkeypatch, engine, caps):
    j, t, codes, lens = rep
    kw, with_tree, k2_sweep = ENGINES[engine]
    max_seeds, scale, k2_scale = CAPS[caps]
    if k2_sweep:
        monkeypatch.setenv("FGDP_K2_SWEEP", k2_sweep)
    else:
        monkeypatch.delenv("FGDP_K2_SWEEP", raising=False)
    kw = dict(kw, max_seeds=max_seeds, prev_cap=20, scale=scale,
              k2_scale=k2_scale)
    jt = dict(lcp_tree=j["tree"], lcp_isa=j["isa"]) if with_tree else {}
    tt = dict(lcp_tree=t["tree"], lcp_isa=t["isa"]) if with_tree else {}
    active = np.ones(len(lens), bool)
    jb = jax.jit(functools.partial(jseeding.collect_seeds,
                                   opt=JAlignConfig(), **kw))(
        j["dfm"], j["dref"], jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(active), **jt)
    tb = seeding.collect_seeds(
        t["dfm"], t["dref"], torch.as_tensor(codes), torch.as_tensor(lens),
        torch.as_tensor(active), AlignConfig(), **kw, **tt)
    _eq_batch(jb, tb)
    assert int(tb.count.sum()) > 0
    if caps == "tiny":
        assert bool(tb.overflow.any())


@pytest.fixture(scope="module")
def rep_reads():
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.utils import dna
    from test_torch_seeding import HERE

    pref = PackedReference.from_fasta(os.path.join(HERE, "rep_ref.fa"))
    recs = list(parse_fastq_records(os.path.join(HERE, "rep.fq")))
    return (pref, FMIndex.build(pref.codes), [r[0] for r in recs],
            [dna.encode(r[2]).astype(np.int64) for r in recs],
            [r[3].decode() for r in recs])


def _spy(monkeypatch, module, name, calls):
    inner = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return inner(*a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("lcp,engine", [(False, "smem_all_pos_sweep"),
                                        (None, "smem_all_pos_sweep"),
                                        (True, "smem_all_lcp")])
def test_aligner_engine_follows_lcp(rep_reads, monkeypatch, lcp, engine):
    """Aligner(lcp=False/None) seeds through the sweep and Aligner()
    (lcp=True) through the LCP tree, as fgdp_tpu's Aligner does."""
    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.ops import smem_lcp, smem_sweep
    from fgdp_tpu_torch.pipeline import Aligner

    pref, fm, names, seqs, quals = rep_reads
    kw = {} if lcp is True else dict(lcp=lcp)
    al = Aligner(pref, fm, shapes=BatchShapes(read_len=100, batch_reads=8),
                 device="cpu", **kw)
    assert (al.lcp_tree is not None) == (lcp is True)
    calls = []
    _spy(monkeypatch, smem_sweep, "smem_all_pos_sweep", calls)
    _spy(monkeypatch, smem_lcp, "smem_all_lcp", calls)
    al.align_batch(names[:8], seqs[:8], quals[:8])
    assert calls and set(calls) == {engine}


def test_sweep_aligner_sam_equals_lcp(rep_reads):
    """tests/golden/rep.fq through Aligner(lcp=False) and Aligner(): the
    SAM records of every read that neither ladder leaves overflowed are
    equal (tolerance 0)."""
    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.pipeline import Aligner

    pref, fm, names, seqs, quals = rep_reads
    shapes = BatchShapes(read_len=100, batch_reads=len(seqs))
    out = {}
    for lcp in (False, True):
        al = Aligner(pref, fm, shapes=shapes, lcp=lcp, device="cpu")
        regs = al._device_regs(seqs)
        lines = al.finalize_batch(names, seqs, quals, regs, 0)
        recs = {}
        for ln in lines:
            recs.setdefault(ln.split("\t")[0], []).append(ln)
        out[lcp] = (recs, {names[i] for i in
                           np.flatnonzero(regs["overflow"])})
    (sw, sw_ovf), (lc, lc_ovf) = out[False], out[True]
    both_ok = [n for n in names if n not in sw_ovf | lc_ovf]
    assert len(both_ok) >= len(names) - 8
    for n in both_ok:
        assert sw[n] == lc[n], n


@pytest.fixture(scope="module")
def repeat_rich():
    """Two reads on which fgdp_tpu's LCP K2 and its wave K2 find
    different re-seeds though neither flags overflow: reads 93 and 151
    of chip_smoke.py's sim_reads (seed 1) on scripts/gen_genome.py's
    300 kb repeat-rich genome (seed 0), in both packages."""
    import importlib.util

    from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
    from fgdp_tpu.index.lcptree import LcpTree as JLcpTree
    from fgdp_tpu.index.reference import DeviceReference as JDR
    from fgdp_tpu.index.reference import PackedReference as JPR
    from fgdp_tpu.ops.fm import DeviceFMIndex as JDFM
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.lcptree import LcpTree
    from fgdp_tpu_torch.index.reference import (DeviceReference,
                                                PackedReference)
    from fgdp_tpu_torch.ops.fm import DeviceFMIndex
    from fgdp_tpu_torch.utils import dna

    root = os.path.dirname(os.path.dirname(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g = cs.gen_genome(300_000, seed=0)
    reads = cs.sim_reads(g, 152, 151, seed=1)
    codes = np.stack([reads[i][1] for i in (93, 151)]).astype(np.int32)
    x = np.concatenate([g, dna.revcomp(g)]).astype(np.uint8)
    jp, tp = JPR.from_contigs(["chr"], [g]), PackedReference.from_contigs(
        ["chr"], [g])
    jf, tf = JFMIndex.build(jp.codes), FMIndex.build(tp.codes)
    jl, tl = JLcpTree.build(x, jf.sa), LcpTree.build(x, tf.sa)
    j = dict(dfm=JDFM.from_host(jf), dref=JDR(jp), tree=jnp.asarray(jl.tree),
             isa=jnp.asarray(jl.isa))
    t = dict(dfm=DeviceFMIndex.from_host(tf, device="cpu"),
             dref=DeviceReference(tp, device="cpu"),
             tree=torch.as_tensor(tl.tree), isa=torch.as_tensor(tl.isa))
    return j, t, codes


def test_k2_engines_disagree_as_in_fgdp_tpu(repeat_rich):
    """On these reads each of the port's engines equals fgdp_tpu's, and
    in both packages the LCP engine's last re-seed differs from the wave
    machine's (a fault of both, ROADMAP queue 3)."""
    j, t, codes = repeat_rich
    B, L = codes.shape
    lens = np.full(B, L, np.int32)
    active = np.ones(B, bool)
    out = {}
    for name, kw, tree in (("wave", dict(use_sweep=False), False),
                           ("lcp", {}, True)):
        jt = dict(lcp_tree=j["tree"], lcp_isa=j["isa"]) if tree else {}
        tt = dict(lcp_tree=t["tree"], lcp_isa=t["isa"]) if tree else {}
        jb = jax.jit(functools.partial(jseeding.collect_seeds,
                                       opt=JAlignConfig(), max_seeds=128,
                                       **kw))(
            j["dfm"], j["dref"], jnp.asarray(codes), jnp.asarray(lens),
            jnp.asarray(active), **jt)
        tb = seeding.collect_seeds(
            t["dfm"], t["dref"], torch.as_tensor(codes),
            torch.as_tensor(lens), torch.as_tensor(active), AlignConfig(),
            max_seeds=128, **kw, **tt)
        _eq_batch(jb, tb)
        out[name] = tb
    w, lc = out["wave"], out["lcp"]
    assert not bool(w.overflow.any()) and not bool(lc.overflow.any())
    assert torch.equal(w.count, lc.count)
    for b in range(B):
        c = int(w.count[b])
        rows = [(int(sb.m[b, i]), int(sb.n[b, i]), int(sb.s[b, i]))
                for sb in (w, lc) for i in range(c)]
        assert rows[:c] != rows[c:], b
