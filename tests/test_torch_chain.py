"""The port's chaining against fgdp_tpu's, and the CUDA kernel's logic.

chain_seeds on the same SeedBatch must give an equal ChainBatch, field
by field, to fgdp_tpu's jnp loop; the plain chain loop must equal the
Pallas kernel in interpret mode; and the kernel's own per-read logic
(csrc/chain_loop.cuh), built for the host by g++, must equal the plain
loop and the Pallas kernel: the register path with 32 lanes in lockstep
(chunked seed loads, ballots, shuffles, slots held by lane and
register, the search run one step ahead), the wide path with one serial
lane. All comparisons are exact (tolerance 0)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.align import chain as jchain
from fgdp_tpu.align import seeding as jseeding
from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu.ops.chain_pallas import chain_loop_pallas
from fgdp_tpu_torch.align import chain
from fgdp_tpu_torch.config import AlignConfig
from fgdp_tpu_torch.ops import kernels
from fgdp_tpu_torch.ops.smem import SeedBatch

from test_torch_cuda import chain_edge_seeds, synth_seeds
from test_torch_seeding import (build_both, one_torch_thread,  # noqa: F401
                                read_codes)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def rep_seeds():
    j, t = build_both("rep_ref.fa")
    codes, lens = read_codes("rep.fq", 48)
    jb = jseeding.collect_seeds(
        j["dfm"], j["dref"], jnp.asarray(codes), jnp.asarray(lens),
        jnp.ones(len(lens), bool), JAlignConfig(), max_seeds=64,
        lcp_tree=j["tree"], lcp_isa=j["isa"])
    return j, t, jb, lens


@pytest.mark.parametrize("P,C,jobs", [(192, 24, 0), (24, 3, 96)])
def test_chain_seeds_equal(rep_seeds, P, C, jobs):
    j, t, jb, lens = rep_seeds
    want = jchain.chain_seeds(j["dfm"], j["dref"], jb, jnp.asarray(lens),
                              JAlignConfig(), max_seedpos=P, max_chains=C,
                              use_pallas=False, jobs_cap=jobs)
    tb = SeedBatch(*(_t(a) for a in jb))
    got = chain.chain_seeds(t["dfm"], t["dref"], tb, _t(lens),
                            AlignConfig(), max_seedpos=P, max_chains=C,
                            jobs_cap=jobs)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    if C == 3:
        assert bool(got.overflow.any())


LOOP_CASES = [(7, 20, 48, 8), (8, 9, 64, 3), (9, 5, 40, 64)]


@pytest.mark.parametrize("seed,B,P,C", LOOP_CASES)
def test_plain_loop_equals_pallas(seed, B, P, C):
    l_pac = 5000
    cols = synth_seeds(seed, B, P, l_pac)
    opt = AlignConfig()
    want = chain_loop_pallas(*(jnp.asarray(a) for a in cols), l_pac, C,
                             opt.w, opt.max_chain_gap, interpret=True)
    got = chain.chain_loop_plain(*(_t(a) for a in cols), l_pac, C, opt.w,
                                 opt.max_chain_gap)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy(),
                                      err_msg=k)
    if C == 3:
        assert bool((got["ovf"] & ~_t(cols[5])).any())


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host twin cannot be built")
    return kernels.build_host_twin()


def twin_loop(lib, cols, l_pac, C, w, gap, wide=False):
    """The host twin's register path (its wide path if `wide`)."""
    qbeg, rbeg, slen, rid, valid, ovf = cols
    B, P = qbeg.shape
    arr = [np.ascontiguousarray(a, np.int32) for a in (qbeg, rbeg, slen,
                                                       rid)]
    vb = np.ascontiguousarray(valid, np.uint8)
    ob = np.ascontiguousarray(ovf, np.uint8)
    out = np.zeros((len(chain.LOOP_FIELDS), B, C), np.int32)
    n = np.zeros(B, np.int32)
    ovf_out = np.zeros(B, np.uint8)
    chain_of = np.full((B, P), 7, np.int32)   # every slot is written
    fn = lib.fgdp_chain_loop_wide_host if wide else lib.fgdp_chain_loop_host
    if fn(*(a.ctypes.data for a in arr), vb.ctypes.data, ob.ctypes.data,
          B, P, C, l_pac, w, gap, out.ctypes.data, n.ctypes.data,
          ovf_out.ctypes.data, chain_of.ctypes.data):
        raise ValueError(f"the host twin refused C={C}")
    res = dict(zip(chain.LOOP_FIELDS, out))
    res.update(n=n, ovf=ovf_out.astype(bool), chain_of=chain_of)
    return res


@pytest.mark.parametrize("seed,B,P,C", LOOP_CASES)
def test_kernel_logic_equals_plain(twin, seed, B, P, C):
    l_pac = 5000
    cols = synth_seeds(seed, B, P, l_pac)
    opt = AlignConfig()
    want = chain.chain_loop_plain(*(_t(a) for a in cols), l_pac, C, opt.w,
                                  opt.max_chain_gap)
    got = twin_loop(twin, cols, l_pac, C, opt.w, opt.max_chain_gap)
    for k, v in want.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)


# the register path's lane and chunk boundaries: C slots over 1-8
# registers a lane, P seed slots over 1-4 chunks of 32
EDGE_CS = (1, 31, 32, 33, 64, 256)
EDGE_PS = (1, 31, 32, 33, 100)


@pytest.mark.parametrize("P", EDGE_PS)
@pytest.mark.parametrize("C", EDGE_CS)
def test_kernel_logic_at_edges(twin, C, P):
    """The register path's twin equals the plain loop and the Pallas
    kernel in interpret mode on chain_edge_seeds' reads (no valid slot,
    all valid, invalid runs across chunk boundaries, ties won by the
    chain the previous step opened, rbegs below it, every chain slot
    filled, both strands)."""
    l_pac = 5000
    cols = chain_edge_seeds(7 * C + P, 12, P, l_pac)
    opt = AlignConfig()
    want = chain.chain_loop_plain(*(_t(a) for a in cols), l_pac, C, opt.w,
                                  opt.max_chain_gap)
    pal = chain_loop_pallas(*(jnp.asarray(a) for a in cols), l_pac, C,
                            opt.w, opt.max_chain_gap, interpret=True)
    got = twin_loop(twin, cols, l_pac, C, opt.w, opt.max_chain_gap)
    for k, v in want.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(pal[k]), got[k],
                                      err_msg=k)
    if P > C:
        # more new chains than slots (the all-distinct read): overflow
        # at n == C
        assert bool((got["ovf"] & ~cols[5]).any())


@pytest.mark.parametrize("C", [257, 320])
def test_wide_logic_equals_plain(twin, C):
    """The wide path (C above the register path's 256) with one serial
    lane equals the plain loop; the register path's twin refuses C."""
    l_pac = 5000
    P = 300
    cols = chain_edge_seeds(C, 6, P, l_pac)
    opt = AlignConfig()
    want = chain.chain_loop_plain(*(_t(a) for a in cols), l_pac, C, opt.w,
                                  opt.max_chain_gap)
    got = twin_loop(twin, cols, l_pac, C, opt.w, opt.max_chain_gap,
                    wide=True)
    for k, v in want.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)
    assert int(got["n"].max()) > 256
    assert twin.fgdp_chain_reg_max_c() == 256
    with pytest.raises(ValueError, match="refused"):
        twin_loop(twin, cols, l_pac, C, opt.w, opt.max_chain_gap)
