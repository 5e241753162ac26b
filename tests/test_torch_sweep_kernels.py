"""The sweep engine's kernels, D9 (csrc/sweep_fwd.cuh) and D10
(csrc/sweep_bwd.cuh), through their host twins (csrc/host_twin.cc: each
lane run to its own end, one lane after another) against the port's
torch-op loops (ops/smem_sweep.py fwd_sweep_plain, bwd_entries_plain)
and against fgdp_tpu's fwd_sweep and bwd_entries (jitted, JAX on the
CPU), on the same seeded inputs.

Every output is held exactly (tolerance 0): the entry rows, entry counts
and both overflow flags of the forward phase, and (m, kf, sf) of the
backward phase on flatten_entries' lanes of the same entries. The world
is a 120 kb repeat-rich gen_genome genome; the reads are
tests/test_torch_cuda.py's seed_reads (N runs, lengths L/2 to L, reads
shorter than min_seed_len, random reads, inactive reads) and two reads at
the text's ends: a copy of the genome's first 100 bases behind 30 random
ones, whose leftward walk ends at text position 0, and the reverse
complement of those 100 bases ahead of 30 random ones, whose forward
walk ends at 2 n_ref. The cases run K1's shape (restart, walk) and K2's
(one anchor a lane, with and without the walk), each at the caps
collect_seeds gives and at caps small enough that povf, eovf and
flatten_entries' drop_ovf fire."""

import functools

import jax
import numpy as np
import pytest
import torch

from fgdp_tpu.index.fmindex import FMIndex as JFMIndex
from fgdp_tpu.index.reference import DeviceReference as JDeviceReference
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.ops import fm as jfm
from fgdp_tpu.ops import smem_sweep as jsweep
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import DeviceReference, PackedReference
from fgdp_tpu_torch.ops import fm as fmops
from fgdp_tpu_torch.ops import kernels, smem_sweep
from fgdp_tpu_torch.ops.fm import DeviceFMIndex

from test_torch_cuda import gen_genome, seed_reads
from test_torch_seeding import one_torch_thread  # noqa: F401
from test_torch_smem_wave import both

B, L = 40, 160
FWD = ("em", "en", "ek", "es", "ecount", "povf", "eovf")
# how an anchor ends, in csrc/sweep_fwd.cuh's order (SWEEP_W_MIS ...)
EXITS = ("walk mismatch", "walk read N", "walk read end", "off0", "amb0",
         "die0", "off1", "amb1", "die1", "neither branch")
# the longest code row whose lanes the card stages (csrc/sweep_fwd.cuh:
# eight groups' rows of 16 bytes a 32 positions in 48 KB)
STAGED_MAX_L = 12_288
# name: (restart, walk, prev_cap, entry_cap, bwd lanes a source lane);
# entry_cap 0 is K1's auto cap 2 L + 16, K2's prev_cap + 2
CASES = {
    "k1": (True, True, 20, 0, 44),
    "k1_tight": (True, True, 3, 10, 2),
    "k2_walk": (False, True, 20, 0, 16),
    "k2_no_walk": (False, False, 20, 0, 16),
    "k2_tight": (False, True, 3, 2, 1),
}


def edge_reads(g, rng):
    """Reads at the text's ends: the genome's first 100 bases behind 30
    random ones (leftward walk to text position 0), their reverse
    complement ahead of 30 random ones (forward walk to 2 n_ref)."""
    head = g[:100].astype(np.int32)
    rand = lambda: rng.integers(0, 4, 30).astype(np.int32)
    return [np.concatenate([rand(), head]),
            np.concatenate([(3 - head)[::-1], rand()])]


@pytest.fixture(scope="module")
def ctx():
    g = gen_genome(120_000, seed=3)
    tp = PackedReference.from_contigs(["chr"], [g])
    jp = JPackedReference.from_contigs(["chr"], [g])
    t = dict(dfm=DeviceFMIndex.from_host(FMIndex.build(tp.codes),
                                         device="cpu"),
             codes16=DeviceReference(tp, device="cpu").codes16)
    j = dict(dfm=jfm.DeviceFMIndex.from_host(JFMIndex.build(jp.codes)),
             codes16=JDeviceReference(jp).codes16)
    codes, lens, active = seed_reads(g, B, L, seed=9)
    rng = np.random.default_rng(10)
    for i, r in zip((B - 2, B - 1), edge_reads(g, rng)):
        codes[i] = 4
        codes[i, :len(r)] = r
        lens[i] = len(r)
        active[i] = True
    return dict(t=t, j=j, codes=codes, lens=lens, active=active, rng=rng,
                n_ref=len(g))


def lane_inputs(ctx, restart, walk):
    """(rid, x0, min_intv, active) of K1's shape (a lane a read from x 0,
    min_intv 1) or K2's (two lanes a read at random anchors, min_intv 1-5,
    2-5 without the walk, 85% active)."""
    if restart:
        return (np.arange(B, dtype=np.int32), np.zeros(B, np.int32),
                np.ones(B, np.int32), ctx["active"])
    rng = np.random.default_rng(11 + walk)
    rid = np.repeat(np.arange(B), 2).astype(np.int32)
    x0 = (rng.random(2 * B) * np.maximum(ctx["lens"][rid], 1)) \
        .astype(np.int32)
    mi = rng.integers(1 if walk else 2, 6, 2 * B).astype(np.int32)
    return rid, x0, mi, rng.random(2 * B) < 0.85


def twin_fwd(dfm, codes16, codes, lens, rid, x0, mi, active, prev_cap, E,
             restart, walk, staged=-1, exits=None):
    """D9's host twin on CPU tensors: fwd_sweep's dict; `staged` 1 reads
    the codes from the group's staged row, 0 where they lie, -1 as the
    card chooses by L; `exits`, a zeroed int64[len(EXITS)], counts how
    the anchors end."""
    NL = x0.shape[0]
    _keep, fm_args = fmops.kernel_args(dfm, torch.device("cpu"), "twin")
    i32 = lambda a: a.to(torch.int32).contiguous()
    ins = [i32(codes), i32(lens), i32(rid), i32(x0), i32(mi),
           active.to(torch.bool).contiguous(), codes16.contiguous()]
    out = dict(em=torch.zeros((NL, E), dtype=torch.int32),
               en=torch.zeros((NL, E), dtype=torch.int32),
               ek=torch.zeros((NL, E), dtype=torch.int32),
               es=torch.zeros((NL, E), dtype=torch.int32),
               ecount=torch.full((NL,), -1, dtype=torch.int32),
               povf=torch.ones(NL, dtype=torch.bool),
               eovf=torch.ones(NL, dtype=torch.bool))
    assert kernels.build_host_twin().fgdp_sweep_fwd_host(
        *fm_args, *(a.data_ptr() for a in ins[:7]), codes16.shape[0],
        codes.shape[0], codes.shape[1], NL, E, prev_cap, 2 * dfm.n_ref,
        int(restart), int(walk), *(out[f].data_ptr() for f in FWD),
        None, staged, None if exits is None else exits.data_ptr()) == 0
    return out


def twin_bwd(dfm, codes16, codes, lens, lanes):
    """D10's host twin on flatten_entries' CPU lanes: (m, kf, sf)."""
    NL = lanes["n"].shape[0]
    _keep, fm_args = fmops.kernel_args(dfm, torch.device("cpu"), "twin")
    cols = [lanes[f].to(torch.int32).contiguous()
            for f in ("rid", "anc", "k", "s", "mi")]
    on = lanes["on"].to(torch.bool).contiguous()
    codes_c = codes.to(torch.int32).contiguous()
    lens_c = lens.to(torch.int32).contiguous()
    out = [torch.full((NL,), -7, dtype=torch.int32) for _ in range(3)]
    assert kernels.build_host_twin().fgdp_sweep_bwd_host(
        *fm_args, codes_c.data_ptr(), lens_c.data_ptr(),
        *(c.data_ptr() for c in cols), on.data_ptr(), codes16.data_ptr(),
        codes16.shape[0], codes.shape[0], codes.shape[1], NL,
        2 * dfm.n_ref, *(o.data_ptr() for o in out), None) == 0
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_fwd(prev_cap, E, restart, walk):
    return jax.jit(functools.partial(jsweep.fwd_sweep, prev_cap=prev_cap,
                                     entry_cap=E, restart=restart,
                                     walk=walk))


_jax_bwd = jax.jit(jsweep.bwd_entries)


def _eq(want, got, what):
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got),
                                  err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_twins_equal_torch_and_jax(ctx, case):
    restart, walk, prev_cap, E, mult = CASES[case]
    E = E or (2 * L + 16 if restart else prev_cap + 2)
    t, j = ctx["t"], ctx["j"]
    rid, x0, mi, active = (both(a) for a in lane_inputs(ctx, restart,
                                                        walk))
    codes, lens = both(ctx["codes"]), both(ctx["lens"])
    targs = (codes[1], lens[1], rid[1], x0[1], mi[1], active[1])

    # ---- D9: twin, torch-op loop and fgdp_tpu's loop ----
    want = smem_sweep.fwd_sweep_plain(t["dfm"], *targs, prev_cap, E,
                                      t["codes16"], restart=restart,
                                      walk=walk)
    got = twin_fwd(t["dfm"], t["codes16"], *targs, prev_cap, E, restart,
                   walk)
    jfw = _jax_fwd(prev_cap, E, restart, walk)(
        j["dfm"], codes[0], lens[0], rid[0], x0[0], mi[0], active[0],
        ref_codes16=j["codes16"])
    for f in FWD:
        _eq(want[f], got[f], f"{case} D9 twin: {f}")
        _eq(jfw[f], want[f], f"{case} D9 torch ops vs fgdp_tpu: {f}")
    assert int(want["ecount"].sum()) > 0

    # ---- D10 on the entries' backward lanes ----
    NL_OUT = x0[1].shape[0] * mult
    lanes, drop = smem_sweep.flatten_entries(want, rid[1], mi[1], E, NL_OUT)
    jlanes, jdrop = jsweep.flatten_entries(jfw, rid[0], mi[0], E, NL_OUT)
    _eq(jdrop, drop, f"{case} drop_ovf")
    bw = smem_sweep.bwd_entries_plain(t["dfm"], codes[1], lens[1], lanes,
                                      t["codes16"])
    tw = twin_bwd(t["dfm"], t["codes16"], codes[1], lens[1], lanes)
    jbw = _jax_bwd(j["dfm"], codes[0], lens[0], jlanes, j["codes16"])
    for name, a, b, c in zip(("m", "kf", "sf"), bw, tw, jbw):
        _eq(a, b, f"{case} D10 twin: {name}")
        _eq(c, a, f"{case} D10 torch ops vs fgdp_tpu: {name}")
    on = lanes["on"]
    # walk off: min_intv >= 2, no interval narrows to one suffix
    assert bool(on.any()) and bool((bw[1][on] < -1).any()) == walk
    if case.endswith("tight"):
        assert bool(want["povf"].any()) and bool(want["eovf"].any())
        assert bool(drop.any()) and not bool(drop.all())
    if case == "k1":
        assert not bool(drop.any())
        # the walks at the text's ends: the leftward one of read B - 2
        # stops at text position 0 (kf = -0 - 2); read B - 1's forward
        # walk pushes a single suffix ending at its last copied base
        assert bool((on & (lanes["rid"] == B - 2) & (bw[1] == -2)).any())
        last = want["ecount"][B - 1]
        assert bool(((want["en"][B - 1, :last] == 99)
                     & (want["es"][B - 1, :last] == 1)).any())


def never_ending_lane(ctx):
    """Two K2 lanes (min_intv 1, to run with walk off) of a read of 100
    bases or more: fwd_sweep's inputs from codes to active."""
    i = int(np.flatnonzero(ctx["active"] & (ctx["lens"] >= 100)
                           & (np.arange(B) % 13 != 6))[0])
    rid = torch.tensor([i, i], dtype=torch.int32)
    return (torch.as_tensor(ctx["codes"]), torch.as_tensor(ctx["lens"]),
            rid, torch.tensor([0, 40], dtype=torch.int32),
            torch.ones(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool))


def test_sweep_fwd_twin_ends_a_lane_the_loop_never_ends(ctx):
    """A K2 lane with min_intv 1 and walk off that narrows to one suffix
    then takes neither branch: the torch-op loop would step it forever,
    the kernel's logic ends it with eovf set (its read then escalates),
    staged and in place."""
    t = ctx["t"]
    for staged in (1, 0):
        out = twin_fwd(t["dfm"], t["codes16"], *never_ending_lane(ctx), 20,
                       22, False, False, staged=staged)
        assert bool(out["eovf"].any()) and bool((out["ecount"] > 0).all())


def test_sweep_dispatch_keeps_the_torch_op_loops_on_the_cpu(ctx,
                                                            monkeypatch):
    """fwd_sweep and bwd_entries on CPU tensors run the plain loops (the
    kernels launch only on CUDA tensors with whole FM tables)."""
    t = ctx["t"]
    calls = []
    monkeypatch.setattr(smem_sweep, "fwd_sweep_kernel",
                        lambda *a, **k: calls.append("fwd"))
    monkeypatch.setattr(smem_sweep, "bwd_entries_kernel",
                        lambda *a, **k: calls.append("bwd"))
    seeds = smem_sweep.smem_all_pos_sweep(
        t["dfm"], t["codes16"], torch.as_tensor(ctx["codes"][:4]),
        torch.as_tensor(ctx["lens"][:4]), torch.ones(4, dtype=torch.int32),
        torch.ones(4, dtype=torch.bool), 19, 64, 20)
    assert calls == [] and int(seeds.count.sum()) > 0


_PLAIN = {}


def plain_case(ctx, case):
    """(the case's torch-tensor inputs, fwd_sweep_plain's dict), once a
    case."""
    restart, walk, prev_cap, E, _ = CASES[case]
    E = E or (2 * L + 16 if restart else prev_cap + 2)
    if case not in _PLAIN:
        rid, x0, mi, active = (torch.as_tensor(a) for a in
                               lane_inputs(ctx, restart, walk))
        targs = (torch.as_tensor(ctx["codes"]), torch.as_tensor(ctx["lens"]),
                 rid, x0, mi, active)
        _PLAIN[case] = targs, smem_sweep.fwd_sweep_plain(
            ctx["t"]["dfm"], *targs, prev_cap, E, ctx["t"]["codes16"],
            restart=restart, walk=walk)
    return _PLAIN[case] + ((prev_cap, E, restart, walk),)


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_fwd_twin_in_place_equals_torch(ctx, case):
    """D9's group twin reading the codes where they lie (the card's path
    past the staging cut-off) and from the staged row, each exactly equal
    to the torch-op loop."""
    targs, want, (prev_cap, E, restart, walk) = plain_case(ctx, case)
    t = ctx["t"]
    for staged in (0, 1):
        got = twin_fwd(t["dfm"], t["codes16"], *targs, prev_cap, E, restart,
                       walk, staged=staged)
        for f in FWD:
            _eq(want[f], got[f], f"{case} staged {staged}: {f}")


def test_sweep_fwd_twin_takes_every_exit(ctx):
    """Over the cases' lanes and the never-ending lane, the group twin's
    anchors end at every exit of the logic at least once (the walk's
    mismatch, read N and read end; both occ characters' read end, N and
    death; neither branch)."""
    t = ctx["t"]
    total = np.zeros(len(EXITS), np.int64)
    for case in CASES:
        targs, want, (prev_cap, E, restart, walk) = plain_case(ctx, case)
        for staged in (0, 1):
            ex = torch.zeros(len(EXITS), dtype=torch.int64)
            got = twin_fwd(t["dfm"], t["codes16"], *targs, prev_cap, E,
                           restart, walk, staged=staged, exits=ex)
            _eq(want["ecount"], got["ecount"], case)
            total += ex.numpy()
    # K2 lanes anchored 2-7 bases left of the reads' N runs, so that an
    # occ step's first or second character is an N (amb0, amb1)
    codes, lens = ctx["codes"], ctx["lens"]
    rid, col = np.nonzero((codes >= 4) & (np.arange(L) < lens[:, None]))
    first = np.r_[True, (np.diff(rid) != 0) | (np.diff(col) != 1)]
    rid = np.repeat(rid[first], 6).astype(np.int32)
    x0 = (np.repeat(col[first], 6) - np.tile(np.arange(2, 8),
                                             int(first.sum()))).clip(0)
    lanes = (torch.as_tensor(codes), torch.as_tensor(lens),
             torch.as_tensor(rid), torch.as_tensor(x0.astype(np.int32)),
             torch.ones(len(rid), dtype=torch.int32),
             torch.ones(len(rid), dtype=torch.bool))
    want = smem_sweep.fwd_sweep_plain(t["dfm"], *lanes, 20, 22,
                                      t["codes16"], restart=False)
    for staged in (0, 1):
        ex = torch.zeros(len(EXITS), dtype=torch.int64)
        got = twin_fwd(t["dfm"], t["codes16"], *lanes, 20, 22, False, True,
                       staged=staged, exits=ex)
        for f in FWD:
            _eq(want[f], got[f], f"lanes at N runs, staged {staged}: {f}")
        total += ex.numpy()
    ex = torch.zeros(len(EXITS), dtype=torch.int64)
    twin_fwd(t["dfm"], t["codes16"], *never_ending_lane(ctx), 20, 22, False,
             False, exits=ex)
    total += ex.numpy()
    missing = [e for e, n in zip(EXITS, total) if n == 0]
    assert not missing, (missing, dict(zip(EXITS, total.tolist())))


def long_reads(g, rng, Lc):
    """Four reads in code rows of length Lc: a copy of the genome's first
    Lc bases whose length runs 40 past the row (the walk reads code 0
    there), the next 900 bases with every 97th changed and an N run, and
    two random 150-mers."""
    codes = np.full((4, Lc), 4, np.int32)
    lens = np.array([Lc + 40, 900, 150, 150], np.int32)
    codes[0] = g[:Lc]
    r = g[Lc:Lc + 900].astype(np.int32).copy()
    r[::97] = (r[::97] + 1) % 4
    r[400:420] = 4
    codes[1, :900] = r
    codes[2:, :150] = rng.integers(0, 4, (2, 150))
    return codes, lens


@pytest.mark.parametrize("shape", ["k1", "k2_walk"])
def test_sweep_fwd_twin_past_the_staging_cut_off(ctx, shape):
    """Code rows one position past the card's staging cut-off (the card
    then reads them where they lie, `fgdp_sweep_fwd_staged_host`): the
    twin as the card chooses and staged, the torch-op loop and
    fgdp_tpu's fwd_sweep exactly equal, K1's and K2's shapes."""
    lib = kernels.build_host_twin()
    Lc = STAGED_MAX_L + 1
    assert lib.fgdp_sweep_fwd_staged_host(STAGED_MAX_L) == 1
    assert lib.fgdp_sweep_fwd_staged_host(Lc) == 0
    g = gen_genome(120_000, seed=3)
    codes, lens = long_reads(g, np.random.default_rng(5), Lc)
    restart, walk, prev_cap, _, _ = CASES[shape]
    if restart:
        lanes = (np.arange(4, dtype=np.int32), np.zeros(4, np.int32),
                 np.ones(4, np.int32), np.ones(4, bool))
        E = 2 * Lc + 16
    else:
        rid = np.repeat(np.arange(4), 3).astype(np.int32)
        x0 = np.array([0, 5000, 12_300, 0, 300, 850, 0, 60, 149, 0, 10, 100],
                      np.int32)
        lanes = (rid, x0, np.array([1, 2, 3] * 4, np.int32),
                 np.ones(12, bool))
        E = prev_cap + 2
    t, j = ctx["t"], ctx["j"]
    arrs = [both(a) for a in (codes, lens) + lanes]
    targs = [a[1] for a in arrs]
    want = smem_sweep.fwd_sweep_plain(t["dfm"], *targs, prev_cap, E,
                                      t["codes16"], restart=restart,
                                      walk=walk)
    jfw = _jax_fwd(prev_cap, E, restart, walk)(
        j["dfm"], *(a[0] for a in arrs), ref_codes16=j["codes16"])
    for staged in (-1, 1):
        got = twin_fwd(t["dfm"], t["codes16"], *targs, prev_cap, E, restart,
                       walk, staged=staged)
        for f in FWD:
            _eq(want[f], got[f], f"{shape} staged {staged}: {f}")
    for f in FWD:
        _eq(jfw[f], want[f], f"{shape} torch ops vs fgdp_tpu: {f}")
    assert int(want["ecount"].sum()) > 0


def edge_rows(g):
    """Code rows of L' = 150 (no multiple of 32) whose reads meet the
    row's edges in a walk: row 0 copies 150 genome bases followed in the
    genome by two A's, with length 190 (positions 150-189 read code 0, so
    the walk matches on past the row), row 1 starts with a T; rows 2-9
    hold 150 genome bases but lengths 100-149 (bases past the length
    read bad)."""
    Lr = 150
    p = next(i for i in range(len(g) - Lr - 2)
             if g[i + Lr] == 0 and g[i + Lr + 1] == 0 and g[i + Lr - 1])
    codes = np.stack([g[p:p + Lr]] + [g[q:q + Lr] for q in
                                      range(7000, 16000, 1000)])
    codes = codes.astype(np.int32)
    codes[1, 0] = 3
    lens = np.array([Lr + 40, Lr] + [100 + 7 * i for i in range(8)],
                    np.int32)
    return codes, lens


@pytest.mark.parametrize("shape", ["k1", "k2_walk"])
def test_sweep_fwd_twin_reads_the_row_edges(ctx, shape):
    """The walk's readings at a row's edges: a position at or past L but
    below the length reads code 0, a base past the length reads bad. The
    twin staged and in place, the torch-op loop and fgdp_tpu's fwd_sweep
    exactly equal, K1's and K2's shapes."""
    codes, lens = edge_rows(gen_genome(120_000, seed=3))
    n = codes.shape[0]
    restart, walk, prev_cap, _, _ = CASES[shape]
    if restart:
        lanes = (np.arange(n, dtype=np.int32), np.zeros(n, np.int32),
                 np.ones(n, np.int32), np.ones(n, bool))
        E = 2 * codes.shape[1] + 16
    else:
        rid = np.repeat(np.arange(n), 3).astype(np.int32)
        x0 = np.tile(np.array([0, 40, 90], np.int32), n)
        lanes = (rid, x0, np.ones(3 * n, np.int32), np.ones(3 * n, bool))
        E = prev_cap + 2
    t, j = ctx["t"], ctx["j"]
    arrs = [both(a) for a in (codes, lens) + lanes]
    targs = [a[1] for a in arrs]
    want = smem_sweep.fwd_sweep_plain(t["dfm"], *targs, prev_cap, E,
                                      t["codes16"], restart=restart,
                                      walk=walk)
    jfw = _jax_fwd(prev_cap, E, restart, walk)(
        j["dfm"], *(a[0] for a in arrs), ref_codes16=j["codes16"])
    for staged in (0, 1):
        got = twin_fwd(t["dfm"], t["codes16"], *targs, prev_cap, E, restart,
                       walk, staged=staged)
        for f in FWD:
            _eq(want[f], got[f], f"{shape} staged {staged}: {f}")
    for f in FWD:
        _eq(jfw[f], want[f], f"{shape} torch ops vs fgdp_tpu: {f}")
    if restart:
        # read 0's walk matched past its row: an entry ends beyond L'
        assert int(want["en"][0].max()) >= codes.shape[1]
