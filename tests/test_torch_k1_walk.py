"""K1's packed WALK compare (csrc/smem_lcp.cuh, lcp_walk) on the CPU.

A WALK step compares q[l-1-j] with text[pos-1-j], j < 64, as one packed
compare of two 128-bit windows: an XOR of the 2-bit codes, the read's N
mask and the range masks ORed in, the first bad j by a count of leading
zeros. These tests hold it exactly (tolerance 0) against the port's
torch-op loop and fgdp_tpu's smem_all_lcp, with the codes staged (the
card's shared-memory rows) and read where they lie:

- one step on crafted lanes against the plain version's own WALK step
  (ops/smem_lcp._walk_step): every offset of pos in a text word, 64 and
  63 characters matched, a read N inside the window and at l - 1, codes
  below 0 and above 3, the read's start and the text's start inside the
  window, positions at or past L (read as A) and past len, past the
  text's end, and pos looked up from SA;
- the whole machine on reads built so that their walks meet those edges
  (checked on the twin's log of its WALK steps), against
  smem_all_lcp_plain and fgdp_tpu. In the machine l never exceeds len,
  a walk at or past L never starts (EXT skips those positions one at a
  time) and the text's end never falls in a window (pos is at most the
  text's length): those edges are the first test's."""

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
from fgdp_tpu.ops import smem_lcp as jlcp
from fgdp_tpu.utils import dna as jdna
from fgdp_tpu_torch.index.reference import packed_window
from fgdp_tpu_torch.ops import kernels, smem_lcp
from fgdp_tpu_torch.ops.smem import _empty_seeds
from fgdp_tpu_torch.ops.smem_sweep import pack_reads
from fgdp_tpu_torch.utils import dna

from test_torch_cuda import OPT, seed_k1_inputs, seed_index, seed_tables
from test_torch_seed_kernels import _batch, _eq, _fm_args, _out, _p
from test_torch_seeding import one_torch_thread  # noqa: F401

GENOME = 30_000    # uniform random bases: 20-mers are unique
L = 160            # the batch's row length
S = 64             # seed slots a read
T = smem_lcp.WALK_T


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(13)
    g = rng.integers(0, 4, GENOME).astype(np.uint8)
    index = seed_index(g)
    t = seed_tables(index, "cpu")
    x = np.concatenate([index[0].codes, dna.revcomp(index[0].codes)]) \
        .astype(np.int32)
    jp = JPackedReference.from_contigs(["chr"], [g])
    jf = JFMIndex.build(jp.codes)
    jx = np.concatenate([jp.codes, jdna.revcomp(jp.codes)]).astype(np.uint8)
    jl = JLcpTree.build(jx, jf.sa)
    j = (jfm.DeviceFMIndex.from_host(jf), JDeviceReference(jp),
         jnp.asarray(jl.tree), jnp.asarray(jl.isa))
    return dict(t=t, j=j, x=x, l2ref=2 * t[0].n_ref)


def test_text_is_the_doubled_reference(world):
    """The packed words the WALK reads are the doubled text x (so the
    tests below can build reads from x)."""
    x, l2ref = world["x"], world["l2ref"]
    assert x.size == l2ref
    got = packed_window(world["t"][1].codes16, l2ref,
                        torch.tensor([0], dtype=torch.int32), l2ref)[0]
    np.testing.assert_array_equal(got.numpy(), x)


# ---------------------------------------------------------------- one step

def _lane(rng, x, pos, l, d, L_=L, len_=None, bad="mism"):
    """A read row whose q[l-1-j] equals x[pos-1-j] for j < d (where that
    text position exists) and then differs (bad "mism"), is N ("n"), a
    code below 0 ("neg") or above 3 ("big"); the rest random."""
    row = rng.integers(0, 4, L_).astype(np.int32)
    for j in range(min(d, T)):
        p, tp = l - 1 - j, pos - 1 - j
        if 0 <= p < L_ and 0 <= tp < x.size:
            row[p] = x[tp]
    p, tp = l - 1 - d, pos - 1 - d
    if d < T and 0 <= p < L_:
        if bad == "n":
            row[p] = 4
        elif bad == "neg":
            row[p] = -1
        elif bad == "big":
            row[p] = 7
        elif 0 <= tp < x.size:
            row[p] = (x[tp] + 1) % 4
    return row, (L_ if len_ is None else len_)


def walk_lanes(world):
    """Crafted WALK lanes, each (row, len, l, r, lo, hi, pos), grouped by
    their row length."""
    rng = np.random.default_rng(7)
    x, l2ref = world["x"], world["l2ref"]
    N = l2ref + 1
    lanes = {L: [], 80: []}

    def add(row_len, row, len_, l, pos, r=None, lo=0):
        r = l + 30 if r is None else r
        lanes[row_len].append((row, len_, l, r, lo, lo + 1, pos))

    base = 16 * 700
    for o in range(16):                       # every offset in a word
        for d in (0, 5, 17 + o, 40, 63, 64):
            pos = base + 16 * 3 * o + o + T
            row, n = _lane(rng, x, pos, 150, d)
            add(L, row, n, 150, pos)
    for d in (0, 1, 31, 32, 33, 62, 63):      # read N, code -1, code 7
        for bad in ("n", "neg", "big"):
            pos = 9000 + 3 * d
            row, n = _lane(rng, x, pos, 120, d, bad=bad)
            add(L, row, n, 120, pos)
    for l in (1, 2, 30, 63, 64, 65):          # the read's start
        pos = 12_000 + l
        row, n = _lane(rng, x, pos, l, T)
        add(L, row, n, l, pos, r=l + 25)
    for pos in (0, 1, 15, 16, 40, 63, 64, 65):   # the text's start
        row, n = _lane(rng, x, pos, 100, T)
        add(L, row, n, 100, pos)
    for pos in (l2ref - 70, l2ref - 1, l2ref, l2ref + 1, l2ref + 20,
                l2ref + 70):                  # the text's end and past it
        row, n = _lane(rng, x, min(pos, l2ref), 100, T)
        add(L, row, n, 100, pos)
    for l, len_ in ((150, 145), (100, 90), (64, 60)):   # l past len
        row, _ = _lane(rng, x, 5000 + l, l, T)
        add(L, row, len_, l, 5000 + l)
    for lo in (0, 1, 777, N - 2, N - 1):      # pos from SA
        row, n = _lane(rng, x, 100, 100, 20)
        add(L, row, n, 100, -1, lo=lo)
    for l, len_ in ((80, 120), (110, 120), (120, 120), (100, 200)):
        # positions at or past L = 80 read as A; their text is matched
        # where it is A
        pos = 14_000 + 7 * l
        row, _ = _lane(rng, x, pos, min(l, 80), T, L_=80)
        add(80, row, len_, l, pos)
    return lanes


def _plain_walk(world, rows, lens, l, r, lo, hi, pos):
    dfm, dref, tree, isa = world["t"]
    n = rows.shape[0]
    T32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    st = dict(l=T32(l), r=T32(r), lo=T32(lo), hi=T32(hi), pos=T32(pos),
              mode=torch.full((n,), smem_lcp.MODE_WALK, dtype=torch.int32),
              seeds=_empty_seeds(n, 4, "cpu"))
    out = smem_lcp._walk_step(
        dfm, isa, pack_reads(T32(rows)), dref.codes16,
        torch.arange(n, dtype=torch.int32), T32(lens), OPT.min_seed_len,
        tree.shape[0] - 1, world["l2ref"], st)
    return out


def _twin_walk(world, rows, lens, l, r, lo, hi, pos, staged):
    dfm, dref, tree, isa = world["t"]
    keep, fa = _fm_args(dfm)
    n, L_ = rows.shape
    ia = np.ascontiguousarray(isa.numpy(), np.int32)
    words = np.ascontiguousarray(dref.codes16.numpy(), np.int64)
    arrs = [np.ascontiguousarray(a, np.int32) for a in (rows, lens, l, r,
                                                         lo, hi, pos)]
    state = np.zeros((n, 8), np.int32)
    out = _out(n, 4)
    rc = kernels.build_host_twin().fgdp_lcp_walk_host(
        *fa, _p(ia), _p(arrs[0]), _p(arrs[1]), _p(words), words.shape[0],
        n, L_, tree.shape[0] - 1, world["l2ref"], OPT.min_seed_len, 4,
        *map(_p, arrs[2:]), _p(state), *map(_p, out[:5]), int(staged))
    assert rc == 0 and keep
    return state, _batch(out)


def test_walk_step_equals_plain(world):
    """One packed WALK step of every crafted lane equals the plain
    version's step, state and seed, staged and in place; the lanes'
    outcomes include each kind of stop and a full window."""
    kinds = set()
    for row_len, lanes in walk_lanes(world).items():
        rows = np.stack([ln[0] for ln in lanes])
        cols = [np.array([ln[k] for ln in lanes]) for k in range(1, 7)]
        want = _plain_walk(world, rows, *cols)
        for staged in (True, False):
            state, seeds = _twin_walk(world, rows, *cols, staged)
            for k, f in enumerate(("l", "r", "lo", "hi", "pos", "mode")):
                np.testing.assert_array_equal(
                    state[:, k], want[f].numpy(),
                    err_msg=f"L {row_len}, staged {staged}: {f}")
            _eq(want["seeds"], seeds._replace(overflow=want["seeds"]
                                              .overflow),
                f"L {row_len}, staged {staged}")
        kinds |= set(want["mode"].tolist())
        # a full window: no stop, pos moves 64 left
        assert bool((want["pos"] >= 0).any())
    assert kinds == {smem_lcp.MODE_WALK, smem_lcp.MODE_EXT,
                     smem_lcp.MODE_SHR, smem_lcp.MODE_DEAD}


# ------------------------------------------------------------ the machine

def twin_k1_log(world, codes, lens, active, staged, cap=8192):
    """K1's twin and its WALK steps' log (LoggedStep: read, len, l, pos
    compared from, then l, r, mode, pos)."""
    dfm, dref, tree, isa = world["t"]
    keep, fa = _fm_args(dfm)
    tr = np.ascontiguousarray(tree.numpy(), np.int32)
    ia = np.ascontiguousarray(isa.numpy(), np.int32)
    words = np.ascontiguousarray(dref.codes16.numpy(), np.int64)
    c = np.ascontiguousarray(codes, np.int32)
    ln = np.ascontiguousarray(lens, np.int32)
    act = np.ascontiguousarray(active, np.uint8)
    out = _out(c.shape[0], S)
    log = np.zeros((cap, 8), np.int32)
    steps = kernels.build_host_twin().fgdp_smem_lcp_host(
        *fa, _p(tr), _p(ia), _p(c), _p(ln), _p(act), _p(words),
        words.shape[0], c.shape[0], c.shape[1], tr.shape[0] - 1,
        world["l2ref"], OPT.min_seed_len, S, 24, *map(_p, out),
        int(staged), _p(log), cap)
    assert 0 <= steps <= cap and keep
    return _batch(out), log[:steps]


def _walk_d(log):
    """Each logged step's d (64: the whole window matched)."""
    l0, l1, mode, pos1 = log[:, 2], log[:, 4], log[:, 6], log[:, 7]
    bad = mode == smem_lcp.MODE_EXT          # a read N: l = l2 - 1
    return np.where(pos1 >= 0, T, l0 - l1 - bad.astype(np.int32))


def edge_reads(world):
    """Reads of x whose walks meet the edges: copies (either strand of
    the reference, as x holds both), a substitution 63 and 64 positions
    left of where the walk starts, a read N inside the first window and
    at its l - 1, codes of -1, reads that run past the text's start, rows
    padded past len with bases, not N, and reads longer than L. The walk's start l0
    of a copy comes from a first run's log (EXT reads only positions at
    or right of it)."""
    rng = np.random.default_rng(29)
    x, l2ref = world["x"], world["l2ref"]
    starts = rng.integers(200, l2ref - 400, 96)
    lens = rng.integers(120, L + 1, starts.size)
    codes = np.full((starts.size, L), 4, np.int32)
    for i, (p, n) in enumerate(zip(starts, lens)):
        codes[i, :n] = x[p:p + n]
    # the walk's first step of each copy
    _, log = twin_k1_log(world, codes, lens, np.ones(starts.size, bool),
                         True)
    first = {}
    for row in log:
        first.setdefault(int(row[0]), int(row[2]))
    reads = []
    for i in range(starts.size):
        n, row = int(lens[i]), codes[i].copy()
        l0 = first.get(i)
        kind = i % 8
        if l0 is not None and kind == 1 and l0 - T - 1 >= 0:
            row[l0 - T - 1] = (row[l0 - T - 1] + 1) % 4   # d 64, then 0
        elif l0 is not None and kind == 2 and l0 - T >= 0:
            row[l0 - T] = (row[l0 - T] + 1) % 4           # d 63
        elif l0 is not None and kind == 3 and l0 - 21 >= 0:
            row[l0 - 21] = 4                               # N at j = 20
        elif l0 is not None and kind == 4 and l0 >= 1:
            row[l0 - 1] = 4                                # N at l - 1
        elif kind == 5:
            row[n:] = rng.integers(0, 4, L - n)            # bases past len
        elif kind == 6:
            row[[3, n - 3]] = -1        # EXT reads -1 as A, WALK as N
        reads.append((row, n))
    # past the text's start: 8 random bases, then x from position 0
    for k in range(6):
        n = 100 + 10 * k
        row = np.full(L, 4, np.int32)
        row[:8] = rng.integers(0, 4, 8)
        row[8:n] = x[:n - 8]
        reads.append((row, n))
    # the text's end (either strand's last bases) and reads past L
    for n in (150, 121):
        row = np.full(L, 4, np.int32)
        row[:n] = x[l2ref - n:]
        reads.append((row, n))
    for n in (L + 20, L + 90):
        row = x[3000:3000 + L].copy()
        reads.append((row, n))
    codes = np.stack([r for r, _ in reads]).astype(np.int32)
    lens = np.array([n for _, n in reads], np.int32)
    active = np.ones(len(reads), bool)
    active[17] = False
    return codes, lens, active


@functools.lru_cache(maxsize=None)
def _jax_k1():
    return jax.jit(functools.partial(jlcp.smem_all_lcp,
                                     min_seed_len=OPT.min_seed_len,
                                     max_seeds=S, max_rounds=24))


def test_k1_walk_edges_equal_plain_and_jax(world):
    """The twin (staged and in place) exactly equals smem_all_lcp_plain
    and fgdp_tpu's smem_all_lcp on edge_reads, whose walks start at every
    offset of a text word, match exactly 64 and exactly 63 characters,
    meet a read N inside the window and at l - 1, cross the read's start
    and run into the text's start."""
    codes, lens, active = edge_reads(world)
    t, (jdfm, jdref, jtree, jisa) = world["t"], world["j"]
    args = seed_k1_inputs(t, codes, lens, active)
    want = smem_lcp.smem_all_lcp_plain(*args, S, t[1].codes16)
    jb = _jax_k1()(jdfm, jtree, jisa, jnp.asarray(codes), jnp.asarray(lens),
                   jnp.asarray(active), ref_codes16=jdref.codes16)
    for staged in (True, False):
        got, log = twin_k1_log(world, codes, lens, active, staged)
        _eq(want, got, f"twin (staged {staged}) vs torch")
        _eq(jb, got, f"twin (staged {staged}) vs fgdp_tpu")
    d = _walk_d(log)
    l0, pos0, mode = log[:, 2], log[:, 3], log[:, 6]
    assert set((pos0 & 15).tolist()) == set(range(16))
    stops = log[:, 7] < 0
    assert (d == T).any() and ((d == T - 1) & stops).any()
    # exactly 64: a full window, then a stop at the next step's first j
    at = {(int(r[0]), int(r[2])): int(dd) for r, dd in zip(log, d)}
    assert any(dd == T and at.get((int(r[0]), int(r[4]))) == 0
               for r, dd in zip(log, d))
    n_stop = mode == smem_lcp.MODE_EXT
    assert (n_stop & (d > 0)).any() and (n_stop & (d == 0)).any()
    # the read's start inside the window, the walk ending there
    assert ((l0 < T) & (mode == smem_lcp.MODE_DEAD)).any()
    # the text's start inside the window, the walk stopping on it
    assert ((pos0 < T) & (pos0 - d == 0) & (mode == smem_lcp.MODE_SHR)) \
        .any()
    assert bool((got.k < -1).any())          # walk-resolved seeds
