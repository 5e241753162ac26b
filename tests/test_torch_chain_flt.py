"""The chain filter (D5) of the port against fgdp_tpu's, and the CUDA
kernel's logic.

Three versions of mem_chain_flt must give exactly equal kept flags
(integers: tolerance 0) on the same chain tables: the kernel's own
per-read logic (csrc/chain_flt.cuh, built for the host by g++ and run
with 32 lanes in lockstep), the plain version chain_flt_plain, and the
JAX package's _chain_flt on jnp copies of the same numpy tables. The
tables come from a seed and are dense in overlaps, equal weights and
equal pos; slots past a read's chain count hold garbage that no version
may read. Besides: the plain version and the twin against the scalar
oracle chain_flt_ref on tests/test_chain.py's single-contig reads, a
mask_level / drop_ratio pair whose float32 and float64 products fall on
different sides of the filter's compares, and the whole chain_seeds with
the twin's filter against fgdp_tpu's."""

import dataclasses
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.align import chain as jchain
from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu.testing import oracles
from fgdp_tpu_torch.align import chain
from fgdp_tpu_torch.align.seeding import collect_seeds
from fgdp_tpu_torch.config import AlignConfig
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import DeviceReference, PackedReference
from fgdp_tpu_torch.ops import kernels
from fgdp_tpu_torch.ops.fm import DeviceFMIndex
from fgdp_tpu_torch.ops.smem import SeedBatch

from test_chain import _reads, _setup
from test_torch_chain import rep_seeds  # noqa: F401
from test_torch_cuda import N_CONTIGS, alt_table, flt_tables
from test_torch_seeding import one_torch_thread  # noqa: F401

FIELDS = chain.FLT_FIELDS + ("weight",)
@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host twin cannot be built")
    return kernels.build_host_twin()


def twin_flt(lib, tbl, is_alt, opt, C):
    """The host twin's kept flags (every slot written)."""
    B = len(tbl["n"])
    kept = np.full((B, C), 7, np.int32)
    alt = np.ascontiguousarray(is_alt, np.uint8)
    rc = lib.fgdp_chain_flt_host(
        *(tbl[f].ctypes.data for f in FIELDS), alt.ctypes.data, len(alt),
        B, C, opt.min_chain_weight, opt.min_seed_len, opt.max_chain_gap,
        opt.max_chain_extend, opt.mask_level, opt.drop_ratio,
        kept.ctypes.data)
    assert rc == 0
    return kept


def plain_flt(tbl, is_alt, opt, C):
    st = {f: torch.as_tensor(tbl[f]) for f in chain.FLT_FIELDS}
    dref = SimpleNamespace(is_alt=torch.as_tensor(is_alt),
                           n_contigs=len(is_alt))
    return chain.chain_flt(st, torch.as_tensor(tbl["weight"]), dref, opt,
                           C).numpy()


def jax_flt(tbl, is_alt, opt, C):
    st = {f: jnp.asarray(tbl[f]) for f in chain.FLT_FIELDS}
    dref = SimpleNamespace(is_alt=jnp.asarray(is_alt), n_contigs=len(is_alt))
    jopt = JAlignConfig(**{f.name: getattr(opt, f.name)
                           for f in dataclasses.fields(JAlignConfig)
                           if hasattr(opt, f.name)})
    return np.asarray(jchain._chain_flt(st, jnp.asarray(tbl["weight"]),
                                        dref, jopt, C))


def all_three(lib, tbl, is_alt, opt, C):
    """The three versions' kept flags, held equal; returns them."""
    got = twin_flt(lib, tbl, is_alt, opt, C)
    want = plain_flt(tbl, is_alt, opt, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_flt(tbl, is_alt, opt, C), want)
    return want


def n_f(tbl, opt):
    C = tbl["weight"].shape[1]
    have = np.arange(C)[None, :] < tbl["n"][:, None]
    return (have & (tbl["weight"] >= opt.min_chain_weight)).sum(1)


EDGE_CS = (1, 31, 32, 33, 64, 256, 384)


@pytest.mark.parametrize("C", EDGE_CS)
def test_filter_equal_at_edges(twin, C):
    """Every chain count the warp's passes and scans split into 32s, the
    ladder's widest (256) and repeat-rich widest (384), alt contigs:
    n_f 0, 1 and C all occur, every flag value is made."""
    opt = dataclasses.replace(AlignConfig(), min_chain_weight=30)
    tbl = flt_tables(C, 10, C)
    kept = all_three(twin, tbl, alt_table(), opt, C)
    nf = n_f(tbl, opt)
    assert nf[0] == 0 and nf[1] == 0 and nf[2] == 1 and nf[3] == C
    have = np.arange(C)[None, :] < tbl["n"][:, None]
    assert not kept[~have].any()
    if C >= 32:
        assert {0, 1, 2, 3} <= set(np.unique(kept[have]).tolist())


@pytest.mark.parametrize("C", (33, 384))
@pytest.mark.parametrize("opts", [
    dict(),
    dict(min_chain_weight=45),
    dict(max_chain_extend=1),
    dict(max_chain_extend=2),
    dict(max_chain_extend=2, min_chain_weight=31, max_chain_gap=50),
], ids=["default", "mcw45", "mce1", "mce2", "mce2_mcw31_gap50"])
def test_filter_equal_with_options(twin, C, opts):
    """min_chain_weight above 0, the max_chain_extend cut at 1 and 2
    (the cut fires: fewer chains kept than without it) and a small
    max_chain_gap, with alt contigs."""
    opt = dataclasses.replace(AlignConfig(), **opts)
    tbl = flt_tables(100 + C, 12, C)
    kept = all_three(twin, tbl, alt_table(), opt, C)
    if "max_chain_extend" in opts:
        free = dataclasses.replace(opt, max_chain_extend=1 << 30)
        uncut = plain_flt(tbl, alt_table(), free, C)
        assert ((kept > 0).sum() < (uncut > 0).sum())
        assert (np.isin(kept, (1, 2)).sum(1) <= opt.max_chain_extend).all()


def test_alt_contigs_change_the_flags(twin):
    """With an alt contig the flags differ from the same table without
    one (the alt rule is exercised), and the three versions agree."""
    C = 64
    opt = AlignConfig()
    tbl = flt_tables(5, 16, C)
    with_alt = all_three(twin, tbl, alt_table(), opt, C)
    without = all_three(twin, tbl, np.zeros(N_CONTIGS, bool), opt, C)
    assert (with_alt != without).any()


def oracle_kept(tbl, b, opt):
    """chain_flt_ref's flags for read b by slot (0 for the dropped), its
    chains given in pos order, ties by slot (the B-tree's order)."""
    n = int(tbl["n"][b])
    order = sorted(range(n), key=lambda c: (int(tbl["pos"][b, c]), c))
    chains = [dict(w=int(tbl["weight"][b, c]), beg=int(tbl["fq"][b, c]),
                   end=int(tbl["lq"][b, c] + tbl["ll"][b, c]), is_alt=False,
                   slot=c) for c in order]
    out = np.zeros(tbl["weight"].shape[1], np.int32)
    for c in oracles.chain_flt_ref(chains, opt):
        out[c["slot"]] = c["kept"]
    return out


def oracle_flags(tbl, opt):
    return np.stack([oracle_kept(tbl, b, opt) for b in range(len(tbl["n"]))])


# query-span lengths and weights whose products with the pair below
# round up in float32 and not in float64 (50 * f32(0.3) > 15,
# 100 * f32(0.6) > 60), so the compares there fall apart
F32_SPANS = [30, 50, 90, 100]
F32_WEIGHTS = [15, 27, 30, 50, 60, 90, 100, 150]


def test_float32_products_as_torch_and_xla_round_them(twin):
    """mask_level 0.3 and drop_ratio 0.6: a table from the first seed
    where the scalar oracle, whose products are float64, keeps other
    chains than the float32 filter; the twin, the plain version and
    fgdp_tpu's _chain_flt agree on it. At 0.5 (exact products) the
    oracle agrees on the same table."""
    opt = dataclasses.replace(AlignConfig(), mask_level=0.3, drop_ratio=0.6,
                              min_seed_len=5)
    for seed in range(200):
        tbl = flt_tables(seed, 8, 12, n_contigs=1, spans=F32_SPANS,
                         weights=F32_WEIGHTS)
        tbl["crid"][:] = 0
        f32 = plain_flt(tbl, np.zeros(1, bool), opt, 12)
        if (oracle_flags(tbl, opt) != f32).any():
            break
    else:
        raise AssertionError("no seed below 200 separates the float32 and "
                             "float64 products")
    all_three(twin, tbl, np.zeros(1, bool), opt, 12)
    exact = dataclasses.replace(opt, mask_level=0.5, drop_ratio=0.5)
    np.testing.assert_array_equal(
        oracle_flags(tbl, exact), plain_flt(tbl, np.zeros(1, bool), exact,
                                            12))


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_equals_oracle_on_single_contig_reads(twin, seed):
    """tests/test_chain.py's reads on one random contig, with two of its
    stretches planted again further on (one with 4% of its bases
    changed, one exact), so reads there chain at two or three places:
    seeded and chained by the port on the CPU, the plain filter and the
    twin equal chain_flt_ref read by read."""
    rng = np.random.default_rng(seed)
    jpref, _ = _setup(rng, n_contigs=1)
    g = np.array(jpref.codes, np.uint8)
    src = g[100:400]
    g[700:1000] = np.where(rng.random(300) < 0.04,
                           rng.integers(0, 4, 300), src)
    g[1000:1150] = g[120:270]
    pref = PackedReference.from_contigs(["c0"], [g])
    dref = DeviceReference(pref, device="cpu")
    dfm = DeviceFMIndex.from_host(FMIndex.build(pref.codes), device="cpu")
    B, L = 24, 101
    codes = torch.as_tensor(_reads(rng, pref, B, L))
    lens = torch.full((B,), L, dtype=torch.int32)
    opt = AlignConfig()
    seeds = collect_seeds(dfm, dref, codes, lens,
                          torch.ones(B, dtype=torch.bool), opt,
                          max_seeds=128, prev_cap=64)
    cb = chain.chain_seeds(dfm, dref, seeds, lens, opt, max_seedpos=256,
                           max_chains=32)
    assert not bool(cb.overflow.any())
    tbl = dict(n=cb.n_chains, pos=cb.pos, crid=cb.rid, fq=cb.first_q,
               lq=cb.last_q, ll=cb.last_len, weight=cb.weight)
    tbl = {k: np.ascontiguousarray(v.numpy(), np.int32)
           for k, v in tbl.items()}
    want = oracle_flags(tbl, opt)
    np.testing.assert_array_equal(cb.kept.numpy(), want)
    np.testing.assert_array_equal(
        twin_flt(twin, tbl, np.zeros(1, bool), opt, 32), want)
    assert int(tbl["n"].max()) >= 2 and np.isin(want, (1, 2)).any()


@pytest.mark.parametrize("P,C,jobs", [(192, 24, 0), (24, 3, 96)])
def test_chain_seeds_with_twin_filter_equals_fgdp_tpu(rep_seeds, twin,
                                                      monkeypatch, P, C,
                                                      jobs):
    """The whole chain_seeds with the kernel's logic in place of the
    plain filter, on the repeat-rich golden reads: every ChainBatch field
    equal to fgdp_tpu's."""
    j, t, jb, lens = rep_seeds
    calls = []

    def twin_filter(st, weight, dref, opt, C):
        tbl = {f: np.ascontiguousarray(st[f].numpy(), np.int32)
               for f in chain.FLT_FIELDS}
        tbl["weight"] = np.ascontiguousarray(weight.numpy(), np.int32)
        calls.append(C)
        return torch.as_tensor(twin_flt(twin, tbl, dref.is_alt.numpy(), opt,
                                        C))

    monkeypatch.setattr(chain, "chain_flt", twin_filter)
    want = jchain.chain_seeds(j["dfm"], j["dref"], jb, jnp.asarray(lens),
                              JAlignConfig(), max_seedpos=P, max_chains=C,
                              use_pallas=False, jobs_cap=jobs)
    tb = SeedBatch(*(torch.tensor(np.asarray(a)) for a in jb))
    got = chain.chain_seeds(t["dfm"], t["dref"], tb,
                            torch.tensor(np.asarray(lens)), AlignConfig(),
                            max_seedpos=P, max_chains=C, jobs_cap=jobs)
    assert calls == [C]
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert int((got.kept == 1).sum() + (got.kept == 2).sum()) > 0


class _CudaWeight:
    """Stands in for a CUDA weight tensor at the filter's dispatch."""

    is_cuda = True


def test_cuda_tensors_take_the_kernel(monkeypatch):
    calls = []

    def fail_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain filter")

    monkeypatch.setattr(chain, "chain_flt_plain", fail_plain)
    monkeypatch.setattr(chain, "chain_flt_kernel",
                        lambda *a, **k: calls.append("kernel"))
    chain.chain_flt({}, _CudaWeight(), None, AlignConfig(), 8)
    assert calls == ["kernel"]
