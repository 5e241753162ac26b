"""The seeding kernels' host twins (csrc/host_twin.cc) against the port's
torch-op loops and against fgdp_tpu's functions on the CPU.

The twins run each kernel's own logic: the rank primitives of csrc/fm.cuh
(D1) one interval at a time; K1 (csrc/smem_lcp.cuh, D2) and K2
(csrc/k2_lcp.cuh, D3) with every lane in one thread and the wave
machine's counts taken on the host step by step, the cascade's
compaction included; K3 (csrc/seed_strategy.cuh, D4) one read at a time,
a read's 16 lanes in lockstep, and the group rank function behind it
(fm_forward_extend2_group) on every row of the index.
Every output is held exactly (tolerance 0): seeds, counts and overflow
flags, at default caps and at caps tight enough that the cascade drops
lanes, the round caps bind, and max_seeds and sj_cap overflow. The reads
(tests/test_torch_cuda.py's seed_reads on a 120 kb gen_genome genome)
hold N runs, reads shorter than min_seed_len, random reads, inactive
reads, and unique stretches that K1 resolves by its text walk."""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.index.lcptree import LcpTree as JLcpTree
from fgdp_tpu.index.reference import DeviceReference as JDeviceReference
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.ops import fm as jfm
from fgdp_tpu.ops import smem as jsmem
from fgdp_tpu.ops import smem_k2lcp as jk2
from fgdp_tpu.ops import smem_lcp as jlcp
from fgdp_tpu.utils import dna as jdna
from fgdp_tpu_torch.ops import fm, kernels, smem, smem_k2lcp, smem_lcp
from fgdp_tpu_torch.ops.smem import SeedBatch

from test_torch_cuda import (OPT, gen_genome, k3_cap_reads, k3_edge_reads,
                             seed_index, seed_k1_inputs, seed_k2_jobs,
                             seed_reads, seed_tables)
from test_torch_seeding import one_torch_thread  # noqa: F401

B, L = 64, 250
# K1: (max_seeds, max_rounds); K2: (sj_cap, ascent_cap, max_rounds);
# K3: max_seeds
K1_CAPS = {"default": (160, 24), "ladder": (320, 48), "tight": (4, 1)}
K2_CAPS = {"default": (16, 64, 48), "ladder": (32, 128, 96),
           "tight": (1, 2, 1)}
K3_CAPS = {"default": 160, "tight": 2}


@pytest.fixture(scope="module")
def ctx():
    g = gen_genome(120_000, seed=0)
    index = seed_index(g)
    t = seed_tables(index, "cpu")
    jp = JPackedReference.from_contigs(["chr"], [g])
    jf = JFMIndex.build(jp.codes)
    x = np.concatenate([jp.codes, jdna.revcomp(jp.codes)]).astype(np.uint8)
    jl = JLcpTree.build(x, jf.sa)
    j = (jfm.DeviceFMIndex.from_host(jf), JDeviceReference(jp),
         jnp.asarray(jl.tree), jnp.asarray(jl.isa))
    codes, lens, active = seed_reads(g, B, L, seed=5)
    return dict(t=t, j=j, codes=codes, lens=lens, active=active)


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _fm_args(dfm):
    """The twin's FM arguments (numpy arrays kept alive by the caller's
    list) from a CPU DeviceFMIndex."""
    arrs = [np.ascontiguousarray(t.numpy(), np.int32)
            for t in (dfm.occ_fused, dfm.counts, dfm.c2, dfm.sa)]
    occ, counts, c2, sa = arrs
    return arrs, [_p(occ), occ.shape[0], _p(counts), _p(c2), _p(sa),
                  sa.shape[0], dfm.sentinel_row, dfm.r1_row, dfm.cc_r0,
                  dfm.cc_r1]


def _out(rows, S):
    """Zeroed seed rows as the kernels' wrappers allocate them."""
    return [np.zeros((rows, S), np.int32) for _ in range(4)] + \
        [np.zeros(rows, np.int32), np.zeros(rows, np.uint8)]


def _batch(out):
    m, n, k, s, count, ovf = out
    return SeedBatch(*(torch.as_tensor(a) for a in (m, n, k, s, count)),
                     overflow=torch.as_tensor(ovf.astype(bool)))


def twin_k1(t, codes, lens, active, msl, max_seeds, max_rounds,
            staged=True):
    """K1's twin, the codes read from the staged rows (shared memory on
    the card) or where they lie."""
    dfm, dref, tree, isa = t
    keep, fa = _fm_args(dfm)
    tr = np.ascontiguousarray(tree.numpy(), np.int32)
    ia = np.ascontiguousarray(isa.numpy(), np.int32)
    words = np.ascontiguousarray(dref.codes16.numpy(), np.int64)
    c = np.ascontiguousarray(codes, np.int32)
    ln = np.ascontiguousarray(lens, np.int32)
    act = np.ascontiguousarray(active, np.uint8)
    out = _out(c.shape[0], max_seeds)
    rc = kernels.build_host_twin().fgdp_smem_lcp_host(
        *fa, _p(tr), _p(ia), _p(c), _p(ln), _p(act), _p(words),
        words.shape[0], c.shape[0], c.shape[1], tr.shape[0] - 1,
        2 * dfm.n_ref, msl, max_seeds, max_rounds, *map(_p, out),
        int(staged), None, 0)
    assert rc >= 0 and keep
    return _batch(out)


def twin_k2_lanes(t, codes, lens, jobs, msl, sj_cap, ascent_cap,
                  max_rounds):
    """The K2 twin's lane rows and lane overflow flags."""
    dfm, dref, tree, isa = t
    keep, fa = _fm_args(dfm)
    tr = np.ascontiguousarray(tree.numpy(), np.int32)
    ia = np.ascontiguousarray(isa.numpy(), np.int32)
    c = np.ascontiguousarray(codes, np.int32)
    ln = np.ascontiguousarray(lens, np.int32)
    jb = [np.ascontiguousarray(x.numpy(), np.int32) for x in jobs[:5]]
    on = np.ascontiguousarray(jobs[5].numpy(), np.uint8)
    NK = on.shape[0]
    out = _out(NK, sj_cap)
    rc = kernels.build_host_twin().fgdp_k2_lcp_host(
        *fa, _p(tr), _p(ia), _p(c), _p(ln), *map(_p, jb), _p(on), NK,
        c.shape[1], tr.shape[0] - 1, 2 * dfm.n_ref, msl, sj_cap,
        ascent_cap, max_rounds, *map(_p, out))
    assert rc == 0 and keep
    return _batch(out)


def twin_k2(t, codes, lens, jobs, msl, into, sj_cap, ascent_cap,
            max_rounds):
    """The K2 twin's lanes merged as k2_reseed_lcp_kernel merges them."""
    lanes = twin_k2_lanes(t, codes, lens, jobs, msl, sj_cap, ascent_cap,
                          max_rounds)
    return smem_k2lcp._merge(smem.LaneSeeds(*lanes), lanes.overflow,
                             jobs[0], jobs[5], codes.shape[0],
                             into.m.shape[1], into)


def twin_k3(t, codes, lens, active, max_intv, msl, max_seeds, staged=True,
            work=None):
    """K3's twin (its group's 16 lanes in lockstep), the codes staged in
    the group's buffer or read where they lie; `work`, an int64[4] numpy
    array, receives its work counters."""
    dfm = t[0]
    keep, fa = _fm_args(dfm)
    c = np.ascontiguousarray(codes, np.int32)
    ln = np.ascontiguousarray(lens, np.int32)
    act = np.ascontiguousarray(active, np.uint8)
    out = _out(c.shape[0], max_seeds)
    rc = kernels.build_host_twin().fgdp_seed_strategy_host(
        *fa, _p(c), _p(ln), _p(act), c.shape[0], c.shape[1], max_intv, msl,
        max_seeds, *map(_p, out), None if work is None else _p(work),
        int(staged))
    assert rc == 0 and keep
    return _batch(out)


def _eq(want, got, what):
    for f in SeedBatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      np.asarray(getattr(got, f)),
                                      err_msg=f"{what}: {f}")


def test_fm_twin_equals_torch_and_jax(ctx):
    """occ4, backward_extend2, forward_extend2, init_interval and
    sa_lookup of csrc/fm.cuh on intervals across the table, its ends and
    past them (clamped), every character 0..4."""
    dfm = ctx["t"][0]
    jdfm = ctx["j"][0]
    N = dfm.text_len
    rng = np.random.default_rng(3)
    n = 4000
    k = rng.integers(-40, N + 40, n).astype(np.int32)
    k[:8] = [0, 1, N - 1, N, dfm.sentinel_row, dfm.sentinel_row + 1,
             dfm.r1_row, dfm.r1_row + 1]
    s = np.minimum(rng.integers(0, 300, n), np.maximum(N - k, 0)) \
        .astype(np.int32)
    l = rng.integers(0, N, n).astype(np.int32)
    s2 = np.minimum(s, np.maximum(N - l, 0)).astype(np.int32)
    ca = rng.integers(0, 5, n).astype(np.int32)
    cb = rng.integers(0, 5, n).astype(np.int32)
    keep, fa = _fm_args(dfm)
    out = np.zeros((n, 18), np.int32)
    assert kernels.build_host_twin().fgdp_fm_host(
        *fa, n, _p(k), _p(l), _p(s2), _p(ca), _p(cb), _p(out)) == 0
    # backward_extend2 on (k, s2) too: the twin takes one s for both
    T = lambda a: torch.as_tensor(a)
    J = jnp.asarray
    want_t = np.concatenate([
        fm.occ4(dfm, T(k)).numpy(),
        np.stack([x.numpy() for x in fm.backward_extend2(
            dfm, T(k), T(s2), T(ca), T(cb))], 1),
        np.stack([x.numpy() for tr in fm.forward_extend2(
            dfm, T(k), T(l), T(s2), T(ca), T(cb)) for x in tr], 1),
        np.stack([x.numpy() for x in fm.init_interval(dfm, T(ca))], 1),
        fm.sa_lookup(dfm, T(k)).numpy()[:, None]], axis=1)
    want_j = np.concatenate([
        np.asarray(jfm.occ4(jdfm, J(k))),
        np.stack([np.asarray(x) for x in jfm.backward_extend2(
            jdfm, J(k), J(s2), J(ca), J(cb))], 1),
        np.stack([np.asarray(x) for tr in jfm.forward_extend2(
            jdfm, J(k), J(l), J(s2), J(ca), J(cb)) for x in tr], 1),
        np.stack([np.asarray(x) for x in jfm.init_interval(jdfm, J(ca))],
                 1),
        np.asarray(jfm.sa_lookup(jdfm, J(k)))[:, None]], axis=1)
    np.testing.assert_array_equal(out, want_t)
    np.testing.assert_array_equal(out, want_j)
    assert keep


@functools.lru_cache(maxsize=None)
def _jax_k1(msl, max_seeds, max_rounds):
    return jax.jit(functools.partial(jlcp.smem_all_lcp,
                                     min_seed_len=msl, max_seeds=max_seeds,
                                     max_rounds=max_rounds))


def _k1_plain_live_after_phase0(monkeypatch, args, caps, words):
    """The plain K1's seeds and its live lanes after the first phase (the
    cascade drops lanes when they outnumber max(B >> 1, 8))."""
    seen = []
    inner = smem_lcp._lcp_phase

    def spy(*a):
        st = inner(*a)
        seen.append(int((st["mode"] != smem_lcp.MODE_DEAD).sum()))
        return st

    monkeypatch.setattr(smem_lcp, "_lcp_phase", spy)
    sb = smem_lcp.smem_all_lcp(*args, caps[0], words, max_rounds=caps[1])
    monkeypatch.undo()
    return sb, seen[0]


@pytest.mark.parametrize("caps", sorted(K1_CAPS))
def test_k1_twin_equals_torch_and_jax(ctx, monkeypatch, caps):
    max_seeds, max_rounds = K1_CAPS[caps]
    t, (jdfm, jdref, jtree, jisa) = ctx["t"], ctx["j"]
    args = seed_k1_inputs(t, ctx["codes"], ctx["lens"], ctx["active"])
    want, live0 = _k1_plain_live_after_phase0(
        monkeypatch, args, K1_CAPS[caps], t[1].codes16)
    jb = _jax_k1(OPT.min_seed_len, max_seeds, max_rounds)(
        jdfm, jtree, jisa, jnp.asarray(ctx["codes"]),
        jnp.asarray(ctx["lens"]), jnp.asarray(ctx["active"]),
        ref_codes16=jdref.codes16)
    for staged in (True, False):
        got = twin_k1(t, ctx["codes"], ctx["lens"], ctx["active"],
                      OPT.min_seed_len, max_seeds, max_rounds, staged)
        _eq(want, got, f"twin (staged {staged}) vs torch")
        _eq(jb, got, f"twin (staged {staged}) vs fgdp_tpu")
    walked = (got.k < -1) & (torch.arange(max_seeds)[None, :]
                             < got.count[:, None])
    assert bool(walked.any())          # text-walk seeds, k = -pos - 2
    assert live0 > B >> 1              # the cascade drops lanes
    if caps == "tight":
        assert bool((got.count == max_seeds).any())


@functools.lru_cache(maxsize=None)
def _jax_k2(msl, B_, max_seeds, sj_cap, ascent_cap, max_rounds):
    return jax.jit(functools.partial(
        jk2.k2_reseed_lcp, min_seed_len=msl, B=B_, max_seeds=max_seeds,
        sj_cap=sj_cap, ascent_cap=ascent_cap, max_rounds=max_rounds))


@pytest.mark.parametrize("caps", sorted(K2_CAPS))
def test_k2_twin_equals_torch_and_jax(ctx, caps):
    sj_cap, ascent_cap, max_rounds = K2_CAPS[caps]
    t, (jdfm, jdref, jtree, jisa) = ctx["t"], ctx["j"]
    args = seed_k1_inputs(t, ctx["codes"], ctx["lens"], ctx["active"])
    k1 = smem_lcp.smem_all_lcp(*args, 160, t[1].codes16)
    jobs = seed_k2_jobs(t, ctx["codes"], ctx["lens"], k1)
    assert int(jobs[5].sum()) > 8
    kw = dict(sj_cap=sj_cap, ascent_cap=ascent_cap, max_rounds=max_rounds)
    want = smem_k2lcp.k2_reseed_lcp(
        t[0], t[2], t[3], args[3], args[4], *jobs, OPT.min_seed_len, B,
        160, into=k1, **kw)
    got = twin_k2(t, ctx["codes"], ctx["lens"], jobs, OPT.min_seed_len,
                  k1, **kw)
    _eq(want, got, "twin vs torch")
    J = lambda x: jnp.asarray(x.numpy())
    jb = _jax_k2(OPT.min_seed_len, B, 160, **kw)(
        jdfm, jtree, jisa, jnp.asarray(ctx["codes"]),
        jnp.asarray(ctx["lens"]), *map(J, jobs),
        into=jsmem.SeedBatch(*map(J, k1)))
    _eq(jb, got, "twin vs fgdp_tpu")
    lanes = twin_k2_lanes(t, ctx["codes"], ctx["lens"], jobs,
                          OPT.min_seed_len, **kw)
    assert int(got.count.sum()) > int(k1.count.sum())
    if caps == "tight":
        assert bool((lanes.count == sj_cap).any())
        assert bool(lanes.overflow[jobs[5]].any())


@functools.lru_cache(maxsize=None)
def _jax_k3(max_intv, msl, max_seeds):
    return jax.jit(functools.partial(
        jsmem.seed_strategy, max_intv=max_intv, min_seed_len=msl,
        max_seeds=max_seeds))


@pytest.mark.parametrize("caps", sorted(K3_CAPS))
def test_k3_twin_equals_torch_and_jax(ctx, caps):
    max_seeds = K3_CAPS[caps]
    t, jdfm = ctx["t"], ctx["j"][0]
    msl = OPT.min_seed_len + 1
    want = smem.seed_strategy(
        t[0], torch.as_tensor(ctx["codes"]), torch.as_tensor(ctx["lens"]),
        torch.as_tensor(ctx["active"]), OPT.max_mem_intv, msl, max_seeds)
    got = twin_k3(t, ctx["codes"], ctx["lens"], ctx["active"],
                  OPT.max_mem_intv, msl, max_seeds)
    _eq(want, got, "twin vs torch")
    jb = _jax_k3(OPT.max_mem_intv, msl, max_seeds)(
        jdfm, jnp.asarray(ctx["codes"]), jnp.asarray(ctx["lens"]),
        jnp.asarray(ctx["active"]))
    _eq(jb, got, "twin vs fgdp_tpu")
    assert int(got.count.sum()) > 0
    if caps == "tight":
        assert bool(got.overflow.any())


def test_fm_group_ranks_equal_fetch_and_extend2(ctx):
    """The group form of forward_extend2 (csrc/fm.cuh, K3's kernel): each
    of the 16 lanes' ranks equals fm_fetch's (occ1 and occ2c at l and at
    l + s) on every row of the index, at every character ca (its pair
    code's second character), with cb every character too; and the
    group's six outputs equal fm_forward_extend2's, the torch ops' and
    fgdp_tpu's. The rows at and past the sentinel and r1_row, intervals
    across the sentinel, and the table's ends are among them."""
    dfm = ctx["t"][0]
    jdfm = ctx["j"][0]
    N = dfm.text_len
    rng = np.random.default_rng(11)
    rows = np.arange(-(-N // 32))
    l = np.minimum(rows * 32 + rng.integers(0, 32, rows.size), N)
    edge = np.array([0, 1, N - 1, N, dfm.sentinel_row - 1, dfm.sentinel_row,
                     dfm.sentinel_row + 1, dfm.r1_row - 1, dfm.r1_row,
                     dfm.r1_row + 1])
    l = np.concatenate([l, edge]).clip(0, N)
    ca = np.repeat(np.arange(25) // 5, l.size)
    cb = np.repeat(np.arange(25) % 5, l.size)
    l = np.tile(l, 25).astype(np.int32)
    s = np.minimum(rng.integers(0, 300, l.size), N - l).astype(np.int32)
    # a fifth across the sentinel
    across = (rng.random(l.size) < 0.2) & (l <= dfm.sentinel_row)
    s[across] = np.minimum(dfm.sentinel_row - l[across] + 1 +
                           rng.integers(0, 64, int(across.sum())),
                           N - l[across])
    k = rng.integers(0, N, l.size).astype(np.int32)
    ca, cb = ca.astype(np.int32), cb.astype(np.int32)
    keep, fa = _fm_args(dfm)
    out = np.zeros((l.size, 44), np.int32)
    assert kernels.build_host_twin().fgdp_fm_group_host(
        *fa, l.size, _p(k), _p(l), _p(s), _p(ca), _p(cb), _p(out)) == 0
    np.testing.assert_array_equal(out[:, :16], out[:, 16:32])
    np.testing.assert_array_equal(out[:, 32:38], out[:, 38:44])
    T = lambda a: torch.as_tensor(a)
    want_t = np.stack([x.numpy() for tr in fm.forward_extend2(
        dfm, T(k), T(l), T(s), T(ca), T(cb)) for x in tr], 1)
    J = jnp.asarray
    want_j = np.stack([np.asarray(x) for tr in jfm.forward_extend2(
        jdfm, J(k), J(l), J(s), J(ca), J(cb)) for x in tr], 1)
    np.testing.assert_array_equal(out[:, 32:38], want_t)
    np.testing.assert_array_equal(out[:, 32:38], want_j)
    # every row, the corrections' rows on both sides, and spans across
    # the sentinel were taken
    assert np.unique(l // 32).size >= rows.size
    assert (l > dfm.r1_row).any() and (l <= dfm.r1_row).any()
    assert ((l <= dfm.sentinel_row) & (dfm.sentinel_row < l + s)).sum() > 100
    assert keep


@pytest.mark.parametrize("max_seeds", [160, 2])
@pytest.mark.parametrize("batch", ["edges", "cap"])
def test_k3_twin_edges_equal_torch_and_jax(ctx, batch, max_seeds):
    """K3's twin (codes staged and read where they lie) against the
    torch-op loop and fgdp_tpu's seed_strategy on k3_edge_reads and
    k3_cap_reads; the work counters show the cap."""
    g = gen_genome(120_000, seed=0)
    codes, lens, active = (k3_edge_reads if batch == "edges"
                           else k3_cap_reads)(g)
    t, jdfm = ctx["t"], ctx["j"][0]
    msl = OPT.min_seed_len + 1
    want = smem.seed_strategy(t[0], torch.as_tensor(codes),
                              torch.as_tensor(lens), torch.as_tensor(active),
                              OPT.max_mem_intv, msl, max_seeds)
    jb = _jax_k3(OPT.max_mem_intv, msl, max_seeds)(
        jdfm, jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(active))
    for staged in (True, False):
        work = np.zeros(4, np.int64)
        got = twin_k3(t, codes, lens, active, OPT.max_mem_intv, msl,
                      max_seeds, staged=staged, work=work)
        _eq(want, got, f"twin (staged {staged}) vs torch")
        _eq(jb, got, f"twin (staged {staged}) vs fgdp_tpu")
    L = codes.shape[1]
    assert 0 <= work[1] * 192 <= work[0] and work[1] < work[3]
    if batch == "cap":
        assert work[3] == 2 * L * L
    else:
        assert int(got.count[2]) == 0 and int(got.count[3]) == 0
        assert int(got.count[0]) > 0
        if max_seeds == 2:
            assert bool(got.overflow.any())
