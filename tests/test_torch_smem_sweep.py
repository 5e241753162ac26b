"""The port's sweep (ops/smem_sweep.py: fwd_sweep, flatten_entries,
bwd_entries, emit_merge, smem_all_pos_sweep, smem_lanes_sweep) against
fgdp_tpu's, and against the port's own wave machine, on
tests/test_smem_sweep.py's world (a 600 bp random reference, seed 7)
with test_smem.make_reads.

Against fgdp_tpu every output must be exactly equal (tolerance 0),
overflow flags included: a tight-cap case makes the per-anchor (povf),
per-lane (eovf) and backward-pool (drop_ovf) caps fire. Against the
wave machine the seeds are compared slot for slot with k normalised to
SA positions, as tests/test_smem_sweep.py compares the JAX package's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.ops import smem_sweep as jsweep
from fgdp_tpu_torch.ops import smem, smem_sweep

from test_smem import make_reads
from test_smem_sweep import slots
from test_torch_seeding import one_torch_thread  # noqa: F401
from test_torch_smem_wave import both, eq_fields, world  # noqa: F401


def k1_inputs(world, n_reads, varied, inactive):
    rng, ref, j, t = world
    reads = make_reads(rng, ref, n_reads=n_reads)
    B, L = reads.shape
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32) if varied \
        else np.full(B, L, np.int32)
    return (both(reads.astype(np.int32)), both(lens),
            both(np.ones(B, np.int32)), both(rng.random(B) >= inactive))


K1_CASES = {
    # name: (n_reads, varied, inactive share, prev_cap, entry_cap,
    #        bwd_mult, max_seeds)
    "auto_caps": (24, False, 0.0, 50, 0, 0, 64),
    "varied_inactive": (16, True, 0.2, 50, 0, 0, 64),
    "collect_caps": (24, True, 0.0, 20, 112, 44, 64),
    "tight_caps": (24, True, 0.1, 4, 6, 2, 4),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_all_pos_sweep_equal_jax(world, case):
    n, varied, off, pc, ec, bm, S = K1_CASES[case]
    _, _, j, t = world
    codes, lens, mi, active = k1_inputs(world, n, varied, off)
    kw = dict(min_seed_len=8, max_seeds=S, prev_cap=pc, entry_cap=ec,
              bwd_mult=bm)
    jb = jax.jit(functools.partial(jsweep.smem_all_pos_sweep, **kw))(
        j["dfm"], j["dref"].codes16, codes[0], lens[0], mi[0], active[0])
    tb = smem_sweep.smem_all_pos_sweep(t["dfm"], t["dref"].codes16,
                                       codes[1], lens[1], mi[1],
                                       active[1], **kw)
    eq_fields(jb, tb)
    if case == "tight_caps":
        assert bool(tb.overflow.any())
    else:
        assert int(tb.count.sum()) > 0


def test_sweep_overflow_flags_equal_jax(world):
    """fwd_sweep's povf and eovf and flatten_entries' drop_ovf on their
    own, at caps where each of them fires, with the entries and the
    backward lanes they hand on."""
    _, _, j, t = world
    codes, lens, mi, active = k1_inputs(world, 24, True, 0.0)
    B = codes[1].shape[0]
    rid = both(np.arange(B, dtype=np.int32))
    x0 = both(np.zeros(B, np.int32))
    pc, E, NL_OUT = 4, 6, 2 * B

    def jrun(dfm, codes16, codes, lens, rid, x0, mi, active):
        fw = jsweep.fwd_sweep(dfm, codes, lens, rid, x0, mi, active, pc,
                              E, codes16)
        lanes, drop = jsweep.flatten_entries(fw, rid, mi, E, NL_OUT)
        return fw, lanes, drop

    jfw, jl, jdrop = jax.jit(jrun)(j["dfm"], j["dref"].codes16, codes[0],
                                   lens[0], rid[0], x0[0], mi[0],
                                   active[0])
    tfw = smem_sweep.fwd_sweep(t["dfm"], codes[1], lens[1], rid[1], x0[1],
                               mi[1], active[1], pc, E, t["dref"].codes16)
    tl, tdrop = smem_sweep.flatten_entries(tfw, rid[1], mi[1], E, NL_OUT)
    for k in jfw:
        np.testing.assert_array_equal(np.asarray(jfw[k]), tfw[k].numpy(),
                                      err_msg=k)
    for k in jl:
        np.testing.assert_array_equal(np.asarray(jl[k]), tl[k].numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(np.asarray(jdrop), tdrop.numpy())
    assert bool(tfw["povf"].any()) and bool(tfw["eovf"].any())
    assert bool(tdrop.any()) and not bool(tdrop.all())


def k2_inputs(world, walk):
    rng, ref, j, t = world
    reads = make_reads(rng, ref, n_reads=16)
    B, L = reads.shape
    NJ = 2 * B
    # walk=False is for lanes whose min_intv is >= 2 (K2's occ + 1)
    mi = rng.integers(1 if walk else 2, 6, NJ).astype(np.int32)
    return (B, both(reads.astype(np.int32)), both(np.full(B, L, np.int32)),
            both(np.repeat(np.arange(B), 2).astype(np.int32)),
            both(rng.integers(0, L, NJ).astype(np.int32)), both(mi),
            both(rng.random(NJ) < 0.85))


K2_CASES = {
    # name: (entry_cap, bwd_mult, walk, prev_cap)
    "auto_caps": (0, 0, True, 50),
    "no_walk": (22, 16, False, 20),
    "tight_caps": (4, 1, True, 3),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_lanes_sweep_equal_jax(world, case):
    ec, bm, walk, pc = K2_CASES[case]
    _, _, j, t = world
    B, codes, lens, ridx, x, mi, on = k2_inputs(world, walk)
    kw = dict(min_seed_len=8, prev_cap=pc, B=B, max_seeds=64,
              entry_cap=ec, bwd_mult=bm, walk=walk)
    jb = jax.jit(functools.partial(jsweep.smem_lanes_sweep, **kw))(
        j["dfm"], j["dref"].codes16, codes[0], lens[0], ridx[0], x[0],
        mi[0], on[0])
    tb = smem_sweep.smem_lanes_sweep(t["dfm"], t["dref"].codes16, codes[1],
                                     lens[1], ridx[1], x[1], mi[1], on[1],
                                     **kw)
    eq_fields(jb, tb)
    if case == "tight_caps":
        assert bool(tb.overflow.any())


def norm_slots(seeds, fm, B):
    return slots(seeds._replace(**{f: getattr(seeds, f).numpy()
                                   for f in seeds._fields}), fm, B)


@pytest.fixture(scope="module")
def host_fm(world):
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    _, ref, _, _ = world
    return FMIndex.build(PackedReference.from_contigs(["chr1"],
                                                      [ref]).codes)


def test_k1_sweep_equals_wave(world, host_fm):
    """The port's two K1 engines find the same seeds in the same slots
    (tests/test_smem_sweep.py's check on the port alone)."""
    _, ref, _, t = world
    codes, lens, mi, active = k1_inputs(world, 16, True, 0.2)
    codes, lens, mi, active = codes[1], lens[1], mi[1], active[1]
    B, L = codes.shape
    want = smem.smem_all_pos(t["dfm"], t["dref"].codes, len(ref), codes,
                             lens, mi, active, 8, max_seeds=64,
                             prev_cap=L + 2,
                             ref_codes16=t["dref"].codes16)
    got = smem_sweep.smem_all_pos_sweep(t["dfm"], t["dref"].codes16, codes,
                                        lens, mi, active, 8, max_seeds=64,
                                        prev_cap=L + 2)
    np.testing.assert_array_equal(got.count.numpy(), want.count.numpy())
    assert not bool(got.overflow.any())
    assert norm_slots(got, host_fm, B) == norm_slots(want, host_fm, B)


def test_k2_lanes_sweep_equals_wave(world, host_fm):
    _, ref, _, t = world
    B, codes, lens, ridx, x, mi, on = (a[1] if isinstance(a, tuple) else a
                                       for a in k2_inputs(world, True))
    L = codes.shape[1]
    lanes, _ = smem.smem_one_pos_lanes(
        t["dfm"], t["dref"].codes, len(ref), codes, lens, ridx, x, mi, on,
        8, prev_cap=L + 2, max_out=32, ref_codes16=t["dref"].codes16)
    want = smem.merge_lane_seeds(lanes, ridx, torch.zeros_like(ridx), on,
                                 B, 64)
    got = smem_sweep.smem_lanes_sweep(t["dfm"], t["dref"].codes16, codes,
                                      lens, ridx, x, mi, on, 8,
                                      prev_cap=L + 2, B=B, max_seeds=64)
    np.testing.assert_array_equal(got.count.numpy(), want.count.numpy())
    assert norm_slots(got, host_fm, B) == norm_slots(want, host_fm, B)


def test_pack_reads_read_window(world):
    """tests/test_smem_sweep.py's round trip on the port's packed words."""
    rng, _, _, _ = world
    codes = rng.integers(0, 5, size=(4, 53)).astype(np.int32)
    lens = [53, 53, 20, 1]
    starts = [0, 5, -3, 40]
    got = smem_sweep.read_window(
        smem_sweep.pack_reads(torch.as_tensor(codes)),
        torch.arange(4, dtype=torch.int32),
        torch.tensor(starts, dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32), 32).numpy()
    for i, st in enumerate(starts):
        for c in range(32):
            p = st + c
            want = codes[i, p] if 0 <= p < lens[i] else 4
            assert got[i, c] == min(want, 4), (i, c)
