"""The card probes' plain versions (S1 issue rate, S2 row gather) on the
CPU against numpy transcriptions of the JAX package's two scripts.

The TPU kernels themselves cannot run here: both are closures inside the
scripts' main(), which also times them, and they name TPU memory spaces
(VMEM, ANY, DMA semaphores), so they can be neither imported nor run in
interpret mode on the CPU. The transcriptions below follow their bodies,
scripts/bench_vpu_ceiling.py:44-61 and scripts/bench_gather_pallas.py:
26-49 with the chain of :73-82. The kernels' own per-element logic
(csrc/vpu_ceiling.cuh) runs here through the g++ host twin."""

import numpy as np
import pytest
import torch

from fgdp_tpu_torch.ops import kernels
from fgdp_tpu_torch.probes import gather
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
    assert kernels.LAUNCHES == n0
