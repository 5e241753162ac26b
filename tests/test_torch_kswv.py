"""The port's batched local SW for mate rescue (ops/kswv.py) against
fgdp_tpu's, on the CPU.

`kswv_forward_plain` must give fgdp_tpu.ops.kswv._forward's four outputs
exactly, at default and non-default penalties and on batches of empty
jobs; `ksw_align_local_batch` fgdp_tpu's batch results and the scalar
ksw_align2 transcription's. The kernel's own per-job logic
(csrc/kswv.cuh), built on the host with 32 lanes in lockstep for the
register path and one lane for the wide path, must equal the plain
version at the register path's lane edges and above its widest query,
and the register path (the lanes an anti-diagonal wavefront) must equal
the plain version and fgdp_tpu's _forward at the wavefront's edges:
targets of 0-33 rows, a best decided in the drain, tied row maxima,
padding jobs."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgdp_tpu.align.pair import ksw_align_local as jksw_align_local
from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu.ops import kswv as jkswv
from fgdp_tpu_torch.config import AlignConfig
from fgdp_tpu_torch.ops import kernels, kswv

from test_kswv import _random_jobs
from test_torch_cuda import (KSWV_EDGE_QPS, KSWV_PENALTIES, KSWV_WIDE_QPS,
                             kswv_jobs, kswv_wave_jobs)
from test_torch_seeding import one_torch_thread  # noqa: F401

PACBIO = dict(a=1, b=1, o_del=1, e_del=1, o_ins=1, e_ins=1,
              min_seed_len=17)


def _plain(jobs, pen):
    return [x.numpy() for x in kswv.kswv_forward(
        *(torch.as_tensor(a) for a in jobs), **pen)]


@pytest.mark.parametrize("pen", sorted(KSWV_PENALTIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_equals_jax_forward(seed, pen):
    """On test_kswv's rescue-like jobs, packed and bucketed as the batch
    driver packs them (64 job rows, of which 24 live)."""
    q, t, qlen, tlen = kswv._pack(_random_jobs(np.random.default_rng(seed),
                                               24))
    got = _plain((q, qlen, t, tlen), KSWV_PENALTIES[pen])
    want = jkswv._forward(jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t),
                          jnp.asarray(tlen), **KSWV_PENALTIES[pen])
    assert int(got[0].max()) > 19
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("empty", [0.9, 1.0])
def test_plain_equals_jax_forward_on_empty_batches(empty):
    jobs = kswv_jobs(4, 64, 96, 256, empty=empty)
    got = _plain(jobs, KSWV_PENALTIES["default"])
    q, qlen, t, tlen = (jnp.asarray(a) for a in jobs)
    want = jkswv._forward(q, qlen, t, tlen, **KSWV_PENALTIES["default"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    gone = jobs[3] == 0
    assert (got[0][gone] == 0).all() and (got[1][gone] == -1).all()


# test_kswv's cases: default penalties on 24 jobs (seeds 0 and 1), the
# pacbio profile on 16 (seed 7)
@pytest.mark.parametrize("seed,n,opt", [(0, 24, {}), (1, 24, {}),
                                        (7, 16, PACBIO)],
                         ids=["default-0", "default-1", "pacbio-7"])
def test_batch_equals_jax_and_scalar(seed, n, opt):
    jobs = _random_jobs(np.random.default_rng(seed), n)
    got = kswv.ksw_align_local_batch(jobs, AlignConfig(**opt), "cpu")
    jopt = JAlignConfig(**opt)
    assert got == jkswv.ksw_align_local_batch(jobs, jopt)
    min_sc = jopt.min_seed_len * jopt.a
    assert got == [jksw_align_local(q, t, jopt, min_sc) for q, t in jobs]
    assert sum(g is not None for g in got) >= n // 3


def test_batch_of_no_jobs():
    assert kswv.ksw_align_local_batch([], AlignConfig(), "cpu") == []


def _twin(fn, jobs, pen):
    q, qlen, t, tlen = (np.ascontiguousarray(a, np.int32) for a in jobs)
    J, QP = q.shape
    TP = t.shape[1]
    best, te = np.zeros(J, np.int32), np.zeros(J, np.int32)
    best_row = np.zeros((J, QP), np.int32)
    row_max = np.zeros((J, TP), np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rc = fn(p(q), p(t), p(qlen), p(tlen), J, QP, TP, pen["a"], pen["b"],
            pen["o_del"], pen["e_del"], pen["o_ins"], pen["e_ins"], p(best),
            p(te), p(best_row), p(row_max))
    if rc != 0:
        raise ValueError("host twin refused the jobs")
    return best, te, best_row, row_max


@pytest.mark.parametrize("pen", sorted(KSWV_PENALTIES))
@pytest.mark.parametrize("QP", KSWV_EDGE_QPS)
def test_host_twin_register_path_equals_plain(QP, pen):
    lib = kernels.build_host_twin()
    assert QP <= lib.fgdp_kswv_reg_max_qp()
    jobs = kswv_jobs(QP, 48, QP, 300)
    got = _twin(lib.fgdp_kswv_host, jobs, KSWV_PENALTIES[pen])
    want = _plain(jobs, KSWV_PENALTIES[pen])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert int(got[0].max()) > 0


@pytest.mark.parametrize("pen", sorted(KSWV_PENALTIES))
@pytest.mark.parametrize("QP", (33,) + KSWV_WIDE_QPS)
def test_host_twin_wide_path_equals_plain(QP, pen):
    """The wide path takes any width; above the register path's widest
    only it runs (the register twin refuses there, as the C entry point
    sends such launches to the wide kernel)."""
    lib = kernels.build_host_twin()
    jobs = kswv_jobs(QP + 7, 24, QP, 400)
    pen = KSWV_PENALTIES[pen]
    got = _twin(lib.fgdp_kswv_wide_host, jobs, pen)
    want = _plain(jobs, pen)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if QP > lib.fgdp_kswv_reg_max_qp():
        with pytest.raises(ValueError):
            _twin(lib.fgdp_kswv_host, jobs, pen)


@pytest.mark.parametrize("pen", ["default", "large_e_ins", "pacbio"])
@pytest.mark.parametrize("QP", KSWV_EDGE_QPS)
def test_host_twin_wavefront_edges_equal_plain_and_jax(QP, pen):
    """kswv_wave_jobs' edges through the register path's twin, the plain
    version and fgdp_tpu's _forward: all four outputs equal."""
    lib = kernels.build_host_twin()
    jobs, (te9, te10) = kswv_wave_jobs(QP, QP)
    pen = KSWV_PENALTIES[pen]
    got = _twin(lib.fgdp_kswv_host, jobs, pen)
    want = _plain(jobs, pen)
    jw = jkswv._forward(*(jnp.asarray(a) for a in jobs), **pen)
    for a, b, c in zip(got, want, jw):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    best, te, best_row, row_max = got
    assert (best[6:9] == 0).all() and (te[6:9] == -1).all()
    assert not row_max[6:9].any() and not best_row[6:8].any()
    assert (row_max[1, 1:] == 0).all()
    if QP >= 16:   # the copies' full score is reached nowhere else
        assert best[9] == best[10] == QP * pen["a"]
        assert te[9] == te9 and te[10] == te10


def test_scores_outside_a_byte_take_the_wide_path():
    """A match score or mismatch penalty outside a signed byte leaves the
    register path (its twin refuses, as the C entry point sends the launch
    to the wide path); the wide path equals the plain version there."""
    lib = kernels.build_host_twin()
    jobs = kswv_jobs(12, 24, 160, 300)
    for pen in (dict(KSWV_PENALTIES["default"], a=128),
                dict(KSWV_PENALTIES["default"], b=129)):
        with pytest.raises(ValueError):
            _twin(lib.fgdp_kswv_host, jobs, pen)
        got = _twin(lib.fgdp_kswv_wide_host, jobs, pen)
        for a, b in zip(got, _plain(jobs, pen)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("QP", (33, 160))
def test_host_twin_wavefront_with_negative_insertion_penalties(QP):
    """Negative insertion penalties: the lanes above the wavefront's edge
    must hold H = E = 0 by the select (with penalties >= 0 the edge steps
    leave them at 0 by themselves); twin, plain version and fgdp_tpu's
    _forward equal."""
    lib = kernels.build_host_twin()
    pen = dict(a=1, b=4, o_del=6, e_del=1, o_ins=-7, e_ins=-1)
    jobs = kswv_jobs(3, 24, QP, 200)
    got = _twin(lib.fgdp_kswv_host, jobs, pen)
    jw = jkswv._forward(*(jnp.asarray(a) for a in jobs), **pen)
    for a, b, c in zip(got, _plain(jobs, pen), jw):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
