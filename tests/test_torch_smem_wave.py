"""The port's wave machine (ops/smem.py: smem_one_pos, smem_one_pos_lanes
+ merge_lane_seeds, smem_all_pos with its straggler tier, anchor_next_x
and anchor_chain) against fgdp_tpu's on tests/test_smem_sweep.py's
world (a 600 bp random reference, seed 7) and test_smem.make_reads.

Same inputs through both packages; every output (count, m, n, k, s,
overflow, next_x) must be exactly equal (tolerance 0). Each case calls
the JAX function once, jitted."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.index.reference import DeviceReference as JDeviceReference
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.ops import smem as jsmem
from fgdp_tpu.ops.fm import DeviceFMIndex as JDeviceFMIndex
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import DeviceReference, PackedReference
from fgdp_tpu_torch.ops import smem
from fgdp_tpu_torch.ops.fm import DeviceFMIndex

from test_smem import make_reads
from test_torch_seeding import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def world():
    """tests/test_smem_sweep.py's world, in both packages."""
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, size=600, dtype=np.uint8)
    jp = JPackedReference.from_contigs(["chr1"], [ref])
    tp = PackedReference.from_contigs(["chr1"], [ref])
    jf, tf = JFMIndex.build(jp.codes), FMIndex.build(tp.codes)
    j = dict(dfm=JDeviceFMIndex.from_host(jf), dref=JDeviceReference(jp))
    t = dict(dfm=DeviceFMIndex.from_host(tf, device="cpu"),
             dref=DeviceReference(tp, device="cpu"))
    return rng, ref, j, t


def eq_fields(jb, tb):
    for f in jb._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                      getattr(tb, f).numpy(), err_msg=f)


def both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.as_tensor(a)


def jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


@pytest.mark.parametrize("two_step", [True, False])
def test_smem_one_pos_equal(world, two_step):
    """One anchor pass per read at varied anchors and min_intv, a quarter
    of the lanes inactive, the text window elementwise (no packed
    words)."""
    rng, ref, j, t = world
    reads = make_reads(rng, ref)
    B, L = reads.shape
    codes = both(reads.astype(np.int32))
    lens = both(np.full(B, L, np.int32))
    x = both(rng.integers(0, L, B).astype(np.int32))
    mi = both(rng.integers(1, 4, B).astype(np.int32))
    on = both(rng.random(B) < 0.75)
    jseeds, jnx = jit(jsmem.smem_one_pos, l_pac=len(ref), min_seed_len=8,
                      prev_cap=L + 2, two_step=two_step)(
        j["dfm"], j["dref"].codes, codes=codes[0], lens=lens[0], x=x[0],
        min_intv=mi[0], active=on[0], seeds=jsmem._empty_seeds(B, 32))
    tseeds, tnx = smem.smem_one_pos(
        t["dfm"], t["dref"].codes, len(ref), codes[1], lens[1], x[1],
        mi[1], on[1], 8, smem._empty_seeds(B, 32, "cpu"), L + 2,
        two_step=two_step)
    eq_fields(jseeds, tseeds)
    np.testing.assert_array_equal(np.asarray(jnx), tnx.numpy())
    assert int(tseeds.count.sum()) > 0


@pytest.mark.parametrize("max_out,prev_cap", [(32, 50), (2, 3)])
def test_one_pos_lanes_and_merge_equal(world, max_out, prev_cap):
    """K2-shaped lanes (two jobs a read, random anchors and min_intv,
    inactive lanes) and their merge; the small caps flag overflow."""
    rng, ref, j, t = world
    reads = make_reads(rng, ref, n_reads=16)
    B, L = reads.shape
    NJ = 2 * B
    codes = both(reads.astype(np.int32))
    lens = both(np.full(B, L, np.int32))
    ridx = both(np.repeat(np.arange(B), 2).astype(np.int32))
    x = both(rng.integers(0, L, NJ).astype(np.int32))
    mi = both(rng.integers(1, 6, NJ).astype(np.int32))
    on = both(rng.random(NJ) < 0.85)
    zeros = both(np.zeros(NJ, np.int32))

    def jrun(dfm, codes16, codes, lens, ridx, x, mi, on, zeros):
        lanes, nx = jsmem.smem_one_pos_lanes(
            dfm, j["dref"].codes, len(ref), codes, lens, ridx, x, mi, on,
            8, prev_cap, max_out, ref_codes16=codes16)
        return lanes, nx, jsmem.merge_lane_seeds(lanes, ridx, zeros, on,
                                                 B, 24)

    jl, jnx, jm = jax.jit(jrun)(j["dfm"], j["dref"].codes16, codes[0],
                                lens[0], ridx[0], x[0], mi[0], on[0],
                                zeros[0])
    tl, tnx = smem.smem_one_pos_lanes(
        t["dfm"], t["dref"].codes, len(ref), codes[1], lens[1], ridx[1],
        x[1], mi[1], on[1], 8, prev_cap, max_out,
        ref_codes16=t["dref"].codes16)
    tm = smem.merge_lane_seeds(tl, ridx[1], zeros[1], on[1], B, 24)
    eq_fields(jl, tl)
    eq_fields(jm, tm)
    np.testing.assert_array_equal(np.asarray(jnx), tnx.numpy())
    if max_out == 2:
        assert bool(tl.overflow.any()) and bool(tm.overflow.any())


ALL_POS_CASES = {
    # name: (n_reads, varied lengths, inactive share, packed words,
    #        two_step, prev_cap, max_seeds, tail_frac)
    "full": (24, False, 0.0, True, True, 50, 64, 4),
    "varied_inactive": (16, True, 0.2, True, True, 50, 64, 4),
    "elementwise_one_step": (24, False, 0.0, False, False, 50, 64, 4),
    "no_tail": (16, True, 0.0, True, True, 50, 64, 1),
    "tight_caps": (24, True, 0.1, True, True, 3, 4, 4),
}


@pytest.mark.parametrize("case", list(ALL_POS_CASES))
def test_smem_all_pos_equal(world, case):
    n, varied, off, packed, two_step, pc, S, tf = ALL_POS_CASES[case]
    rng, ref, j, t = world
    reads = make_reads(rng, ref, n_reads=n)
    B, L = reads.shape
    codes = both(reads.astype(np.int32))
    lens = both(rng.integers(L // 2, L + 1, B).astype(np.int32) if varied
                else np.full(B, L, np.int32))
    mi = both(np.ones(B, np.int32))
    active = both(rng.random(B) >= off)
    kw = dict(min_seed_len=8, max_seeds=S, prev_cap=pc, two_step=two_step,
              tail_frac=tf)
    jb = jit(jsmem.smem_all_pos, l_pac=len(ref), **kw)(
        j["dfm"], j["dref"].codes, codes=codes[0], lens=lens[0],
        min_intv=mi[0], active=active[0],
        ref_codes16=j["dref"].codes16 if packed else None)
    tb = smem.smem_all_pos(
        t["dfm"], t["dref"].codes, len(ref), codes[1], lens[1], mi[1],
        active[1], ref_codes16=t["dref"].codes16 if packed else None,
        **kw)
    eq_fields(jb, tb)
    if case == "tight_caps":
        assert bool(tb.overflow.any())
    else:
        assert int(tb.count.sum()) > 0


def test_anchor_next_x_and_chain_equal(world):
    rng, ref, j, t = world
    reads = make_reads(rng, ref)
    B, L = reads.shape
    codes = both(reads.astype(np.int32))
    lens = both(rng.integers(L // 2, L + 1, B).astype(np.int32))

    def jrun(dfm, codes, lens):
        nxt = jsmem.anchor_next_x(dfm, codes, lens)
        return nxt, jsmem.anchor_chain(nxt, lens, B, L)

    jn, jc = jax.jit(jrun)(j["dfm"], codes[0], lens[0])
    tn = smem.anchor_next_x(t["dfm"], codes[1], lens[1])
    tc = smem.anchor_chain(tn, lens[1], B, L)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert tc.sum(1).min() >= 1
