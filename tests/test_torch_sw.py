"""The port's banded SW against fgdp_tpu's, and the CUDA kernel's logic.

The plain PyTorch version must equal ops/sw.sw_extend and the Pallas
kernel in interpret mode exactly (tolerance 0). The kernel's own per-job
logic (csrc/sw_extend.cuh), built for the host by g++ (the host twin),
must equal the plain version too; the kernel itself runs only on the
card (tests/test_torch_cuda.py)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.ops import sw as jsw
from fgdp_tpu.ops.sw_pallas import sw_extend_pallas
from fgdp_tpu_torch.ops import kernels
from fgdp_tpu_torch.ops import sw

from test_torch_cuda import OPT, SW_EDGE_QPS, SW_EDGE_WS, sw_edge_jobs
from test_torch_cuda import SW_CASES as CASES
from test_torch_cuda import sw_pairs as _pairs
from test_torch_cuda import sw_params as _params
from test_torch_cuda import sw_retry_jobs
from test_torch_seeding import one_torch_thread  # noqa: F401


def _jax_ref(qs, qlen, ts, tlen, h0, w, bonus, pallas):
    p = _params(jsw, bonus)
    a = [jnp.asarray(x) for x in (qs, qlen, ts, tlen, h0)]
    if pallas:
        r = sw_extend_pallas(a[0], a[1], a[2], a[3], a[4], w, None, p,
                             interpret=True)
    else:
        r = jsw.sw_extend(a[0], a[1], a[2], a[3], a[4], w, None, p)
    return {k: np.asarray(v) for k, v in r._asdict().items()}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pallas", [False, True])
def test_plain_sw_equals_jax(case, pallas):
    c = CASES[case]
    qs, qlen, ts, tlen, h0 = _pairs(*c["args"])
    want = _jax_ref(qs, qlen, ts, tlen, h0, c["w"], c["bonus"], pallas)
    got = sw.sw_extend(*(torch.as_tensor(x) for x in (qs, qlen, ts)),
                       torch.as_tensor(tlen), torch.as_tensor(h0), c["w"],
                       _params(sw, c["bonus"]))
    for k, v in got._asdict().items():
        np.testing.assert_array_equal(want[k], v.numpy(), err_msg=k)


@pytest.fixture(scope="module")
def twin():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host twin cannot be built")
    return kernels.build_host_twin()


def twin_sw(lib, qs, qlen, ts, tlen, h0, w, p):
    J, QP = qs.shape
    out = np.zeros((6, J), np.int32)
    cells = np.zeros(J, np.int64)
    arr = [np.ascontiguousarray(x, np.int32) for x in (qs, ts, qlen, tlen,
                                                       h0)]
    lib.fgdp_sw_extend_host(*(a.ctypes.data for a in arr), J, QP,
                            ts.shape[1], w, p.o_del, p.e_del, p.o_ins,
                            p.e_ins, p.zdrop, p.end_bonus, p.mat_max,
                            p.mat_mis, p.mat_amb, out.ctypes.data,
                            cells.ctypes.data)
    return out, cells


def _twin_equals_plain(lib, qs, qlen, ts, tlen, h0, w, p):
    out, cells = twin_sw(lib, qs, qlen, ts, tlen, h0, w, p)
    got = sw.sw_extend_plain(*(torch.as_tensor(x) for x in
                               (qs, qlen, ts, tlen, h0)), w, p)
    for i, v in enumerate(got):
        np.testing.assert_array_equal(out[i], v.numpy(),
                                      err_msg=sw.SWResult._fields[i])
    assert (cells >= 0).all() and cells.sum() > 0
    return cells


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_logic_equals_plain(twin, case):
    c = CASES[case]
    _twin_equals_plain(twin, *_pairs(*c["args"]), c["w"],
                       _params(sw, c["bonus"]))


# the card's lane-boundary shapes (tests/test_torch_cuda.py), here with
# the twin's single lane holding every column
@pytest.mark.parametrize("w", SW_EDGE_WS)
@pytest.mark.parametrize("QP", SW_EDGE_QPS)
def test_kernel_logic_at_edge_shapes(twin, QP, w):
    _twin_equals_plain(twin, *sw_edge_jobs(QP + w, QP), w,
                       _params(sw, OPT.pen_clip5))


def test_kernel_logic_on_a_mostly_empty_batch(twin):
    jobs = sw_retry_jobs(12)
    cells = _twin_equals_plain(twin, *jobs, 2 * OPT.w,
                               _params(sw, OPT.pen_clip5))
    assert (cells[jobs[1] == 0] == 0).all()


def test_twin_refuses_query_wider_than_its_columns(twin):
    qs, qlen, ts, tlen, h0 = sw_edge_jobs(13, 255, copies=1)
    out = np.zeros((6, len(qlen)), np.int32)
    arr = [np.ascontiguousarray(x, np.int32) for x in (qs, ts, qlen, tlen,
                                                       h0)]
    p = _params(sw, OPT.pen_clip5)
    assert twin.fgdp_sw_extend_host(
        *(a.ctypes.data for a in arr), len(qlen), 255, ts.shape[1], 100,
        p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop, p.end_bonus, p.mat_max,
        p.mat_mis, p.mat_amb, out.ctypes.data, None) == 1
