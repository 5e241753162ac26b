"""The card probes' plain versions (S1 issue rate, S2 row gather) on the
CPU against numpy transcriptions of the JAX package's two scripts.

The TPU kernels themselves cannot run here: both are closures inside the
scripts' main(), which also times them, and they name TPU memory spaces
(VMEM, ANY, DMA semaphores), so they can be neither imported nor run in
interpret mode on the CPU. The transcriptions below follow their bodies,
scripts/bench_vpu_ceiling.py:44-61 and scripts/bench_gather_pallas.py:
26-49 with the chain of :73-82. The kernels' own per-element logic
(csrc/vpu_ceiling.cuh) runs here through the g++ host twin. The
dependent-gather probe (probes/chase.py, no TPU counterpart) has its
plain chase held against a scalar transcription of csrc/gather_chase.cu's
hop."""

import os

import numpy as np
import pytest
import torch

from fgdp_tpu_torch.ops import kernels
from fgdp_tpu_torch.probes import chase, gather
from fgdp_tpu_torch.probes import vpu_ceiling as vc

from test_torch_seeding import one_torch_thread  # noqa: F401


def numpy_vpu_kernel(x, n_chains, steps):
    """scripts/bench_vpu_ceiling.py's kernel body (mk_kernel), in numpy
    float32: the constants made as jnp.float32(...) makes them."""
    acc = x.copy()
    for _ in range(steps):
        chains = [acc * np.float32(1.0 / (1 << c)) for c in range(n_chains)]
        for _ in range(64 // n_chains):
            chains = [c * np.float32(0.999 - 1e-4 * ci)
                      + np.float32(1e-7 * (ci + 1))
                      for ci, c in enumerate(chains)]
        total = chains[0]
        for c in chains[1:]:
            total = total + c
        acc = total
    return acc


def numpy_int_twin(x, n_chains, steps):
    """The INT32 twin's definition (csrc/vpu_ceiling.cuh) in numpy int32,
    which wraps."""
    acc = x.copy()
    for _ in range(steps):
        chains = [acc ^ vc.SEED[c] for c in range(n_chains)]
        for _ in range(64 // n_chains):
            chains = [np.maximum(c + vc.INC[ci], c - vc.DEC[ci])
                      for ci, c in enumerate(chains)]
        total = chains[0]
        for c in chains[1:]:
            total = total + c
        acc = total
    return acc


@pytest.mark.parametrize("n_chains", vc.CHAINS)
@pytest.mark.parametrize("steps", [3, vc.CHECK_STEPS, vc.STEPS])
def test_vpu_fp32_plain_matches_script(n_chains, steps):
    """Bit for bit, overflow to inf included (the script's 151 steps
    overflow float32 for inputs in [0, 1))."""
    x = np.random.default_rng(n_chains).random((5, 48), np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        want = numpy_vpu_kernel(x, n_chains, steps)
    got = vc.vpu_ceiling(torch.as_tensor(x), steps, n_chains).numpy()
    assert np.array_equal(got, want)
    assert np.isfinite(got).all() == (steps <= vc.CHECK_STEPS)


@pytest.mark.parametrize("n_chains", vc.CHAINS)
def test_vpu_int32_plain_matches_definition(n_chains):
    x = np.random.default_rng(1).integers(-2**31, 2**31, (4, 40)) \
        .astype(np.int32)
    with np.errstate(over="ignore"):
        want = numpy_int_twin(x, n_chains, 17)
    got = vc.vpu_ceiling(torch.as_tensor(x), 17, n_chains).numpy()
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def twin():
    return kernels.build_host_twin()


def _twin_run(lib, x, steps, n_chains):
    out = np.empty_like(x)
    rc = lib.fgdp_vpu_ceiling_host(
        x.ctypes.data, out.ctypes.data, x.size, steps, n_chains,
        int(x.dtype == np.int32),
        *(a.ctypes.data for a in (vc.SCALE, vc.MUL, vc.ADD, vc.SEED,
                                  vc.INC, vc.DEC)))
    assert rc == 0
    return out


@pytest.mark.parametrize("n_chains", vc.CHAINS)
def test_vpu_host_twin_against_plain(twin, n_chains):
    """The kernel's logic (fused multiply-adds) within FP32_RTOL of the
    plain version (unfused), and the INT32 twin exactly equal."""
    rng = np.random.default_rng(2)
    xf = rng.random(3000, np.float32)
    got = _twin_run(twin, xf, vc.CHECK_STEPS, n_chains)
    want = vc.vpu_ceiling(torch.as_tensor(xf), vc.CHECK_STEPS,
                          n_chains).numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= vc.FP32_RTOL
    assert rel.max() > 0              # the fused rounding does differ
    xi = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    assert np.array_equal(
        _twin_run(twin, xi, 11, n_chains),
        vc.vpu_ceiling(torch.as_tensor(xi), 11, n_chains).numpy())


def test_vpu_counts():
    x = torch.zeros((2, 3))
    issue, work = vc.ops_per_call(x, 10, 8)
    assert issue == 6 * 10 * 64 and work == 6 * 10 * (128 + 15)
    issue, work = vc.ops_per_call(x.int(), 10, 8)
    assert issue == 6 * 10 * 192 and work == issue + 6 * 10 * 15


def numpy_gather_kernel(idx, tbl):
    """scripts/bench_gather_pallas.py's gather_kernel: row idx[i] of the
    table copied to output row i, one copy per row (D in flight changes
    only when each copy waits, not what lands)."""
    out = np.empty((len(idx), tbl.shape[1]), tbl.dtype)
    for i in range(len(idx)):
        out[i, :] = tbl[idx[i], :]
    return out


def numpy_chain(tbl, i0, steps):
    """The script's chain (:73-82)."""
    nblocks = tbl.shape[0]
    t, i, acc = 0, i0.copy(), np.zeros(len(i0), np.int32)
    while t < steps:
        rows = numpy_gather_kernel(i, tbl)
        s = np.sum(rows[:, :24], axis=1, dtype=np.int32)
        t, i, acc = t + 1, (i + (s & 1023) + 1) % nblocks, acc + s
    return acc


def test_gather_plain_matches_script():
    tbl = gather.table("cpu", seed=3, rows=2000)
    idx = gather.indices("cpu", 300, seed=4, rows=2000)
    want = numpy_gather_kernel(idx.numpy(), tbl.numpy())
    assert np.array_equal(gather.gather_rows(tbl, idx).numpy(), want)


@pytest.mark.parametrize("n", [64, 1024])
def test_gather_chain_matches_script(n):
    tbl = gather.table("cpu", seed=5, rows=3000)
    i0 = gather.indices("cpu", n, seed=n, rows=3000)
    with np.errstate(over="ignore"):
        want = numpy_chain(tbl.numpy(), i0.numpy(), 20)
    got = gather.chain(tbl, i0, gather.gather_rows, steps=20)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the sums wrap int32 in both: a table of values up to 2^31
    assert (want < 0).any()


def test_gather_counts():
    assert gather.row_bytes(10) == 10 * 128 * 4 * 2 + 40


SASS = """
        code for sm_90a
                Function : _Z16sw_extend_kernelILi5EEvPKi
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
                                                                /* 0x000fe40000000800 */
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   VIADDMNMX R3, R2, R4, R3, !PT ;
        /*0030*/                   NOP ;
        /*0040*/                   SHFL.UP PT, R5, R3, 0x1, RZ ;
        /*0050*/              @!P0 BRA 0x20 ;
        /*0060*/                   IMAD.MOV.U32 R6, RZ, RZ, R2 ;
        /*0070*/               @P1 BRA 0x10 ;
        /*0080*/                   EXIT ;
        /*0090*/                   WARPSYNC.COLLECTIVE R7, 0xc0 ;
        /*00a0*/                   SHFL.UP P6, R5, R3, R8, R9 ;
        /*00b0*/                   BRA 0x0 ;
.L_x_9:
        /*00c0*/                   BRA `(.L_x_9) ;
"""


def test_sass_outer_loop_is_the_largest_backward_span():
    from fgdp_tpu_torch.probes import sass

    funcs, labels = sass.parse(SASS)
    name = "_Z16sw_extend_kernelILi5EEvPKi"
    assert list(funcs) == [name] and len(funcs[name]) == 13
    assert labels[name] == {".L_x_9": 0xc0}
    n, ops = sass.outer_loop(funcs[name], labels[name])
    # 0x10 .. 0x70 without the NOP; the slow path after EXIT is no loop
    assert n == 6 and ops["BRA"] == 2 and ops["VIADDMNMX"] == 1
    assert sass.opcode("@!P0 SHFL.UP PT, R5, R3, 0x1, RZ") == "SHFL"
    assert sass.outer_loop(funcs[name][:3], {}) is None


def test_sass_last_loop_takes_the_later_top_level_loop():
    """Two loops in a row (kswv's edge steps, then its main steps inside
    a loop over chunks), then a loop that only stores: the last
    innermost one with a shuffle."""
    from fgdp_tpu_torch.probes import sass

    text = """
        code for sm_90a
                Function : _Z16kswv_regs_kernelILi5EEvPKi
        /*0000*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0010*/                   SEL R3, R2, R4, P0 ;
        /*0020*/                   SHFL.UP PT, R5, R3, 0x1, RZ ;
        /*0030*/               @P1 BRA 0x0 ;
        /*0040*/                   LDG.E R6, [R2] ;
        /*0050*/                   PRMT R6, R2, 0x8880, RZ ;
        /*0060*/                   SHFL.IDX PT, R8, R7, 0x1f, 0x1f ;
        /*0070*/               @P2 BRA 0x50 ;
        /*0080*/               @P3 BRA 0x40 ;
        /*0090*/                   STG.E [R2], R3 ;
        /*00a0*/               @P4 BRA 0x90 ;
        /*00b0*/                   EXIT ;
"""
    funcs, labels = sass.parse(text)
    name = "_Z16kswv_regs_kernelILi5EEvPKi"
    n, ops = sass.last_loop(funcs[name], labels[name])
    # 0x50 .. 0x70: after the first loop, inside the chunk loop 0x40 ..
    # 0x80, before the store loop
    assert n == 3 and ops["SHFL"] == 1 and ops["BRA"] == 1
    assert sass.outer_loop(funcs[name], labels[name])[0] == 5
    assert sass.last_loop(funcs[name][:3], {}) is None


def test_sass_row_loops_by_instantiation(monkeypatch):
    """pairhmm_row_loops takes the register kernel's instantiations by K
    and leaves the wide kernel out."""
    from fgdp_tpu_torch.probes import sass

    hmm = SASS.replace("_Z16sw_extend_kernelILi5EEvPKi",
                       "_Z19pairhmm_regs_kernelILi13EEvPKi")
    wide = SASS.replace("_Z16sw_extend_kernelILi5EEvPKi",
                        "_Z19pairhmm_wide_kernelPKi")
    seen = []

    def fake(so):
        seen.append(os.path.basename(so))
        return sass.parse(hmm + wide)

    monkeypatch.setattr(sass, "functions", fake)
    loops = sass.pairhmm_row_loops()
    assert seen == ["pairhmm.so"] and list(loops) == [13]
    assert loops[13][0] == 6 and sass.sw_row_loops() == {}


def test_sass_stack_frames_from_res_usage():
    """Each function's STACK:n of a `cuobjdump -res-usage` listing, the
    figures on the name's line or on the next, the largest over the
    library's images."""
    from fgdp_tpu_torch.probes import sass

    text = """
Fatbin elf code:
================
arch = sm_90a
Resource usage:
 Common:
  GLOBAL:0
 Function _Z20seed_strategy_kernel6K3Argsi:
  REG:40 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:616 TEXTURE:0
 Function _Z15smem_lcp_kernelILi1EEv7LcpArgsiPiS1_: REG:64 STACK:832 SHARED:16
 Function _Z20seed_strategy_kernel6K3Argsi:
  REG:38 STACK:16 SHARED:0 LOCAL:0
"""
    assert sass.parse_res_usage(text) == {
        "_Z20seed_strategy_kernel6K3Argsi": 16,
        "_Z15smem_lcp_kernelILi1EEv7LcpArgsiPiS1_": 832}
    assert sass.parse_res_usage("Resource usage:\n Common:\n") == {}


def numpy_chase(occ, chains, hops, p0):
    """csrc/gather_chase.cu's chains, one scalar hop at a time."""
    nb = occ.shape[0]
    out = np.zeros((chains, 2), np.int64)
    for t in range(chains):
        p = (p0 + 7919 * t) % nb
        q = p + 1 if p + 1 < nb else p
        x = 0
        for h in range(hops):
            s = int(occ[p].astype(np.int64).sum() +
                    occ[q].astype(np.int64).sum()) & 0xFFFFFFFF
            x = s - 2**32 if s >= 2**31 else s
            p = ((s & 0x7FFFFFFF) * 40503 + h) % nb
            q = min(p + ((s >> 8) & 3), nb - 1)
        out[t] = (x, p)
    return out


@pytest.mark.parametrize("hops", [0, 1, 40])
def test_chase_plain_matches_the_kernels_hop(hops):
    occ = chase.table("cpu", seed=2, rows=997)
    got = chase.chase(occ, 5, hops, 31)
    assert got.dtype == torch.int32 and got.shape == (5, 2)
    assert np.array_equal(got.numpy(), numpy_chase(occ.numpy(), 5, hops, 31))
    assert (got[:, 1] < 997).all()
    if hops > 1:   # the sums wrap int32 in both
        assert (got[:, 0] < 0).any()


def test_probe_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise before any
    build."""
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        vc.vpu_ceiling_kernel(torch.zeros(8), 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_rows_kernel(torch.zeros((4, 8), dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="n_chains"):
        vc.vpu_ceiling(torch.zeros(8), 3, 6)
    with pytest.raises(ValueError, match="CUDA"):
        chase.chase_kernel(torch.zeros((4, 24), dtype=torch.int32), 1, 2)
    assert kernels.LAUNCHES == n0
