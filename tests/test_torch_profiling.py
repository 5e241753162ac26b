"""The port's Profiler against fgdp_tpu's: the same sequence of phase,
add and reset calls, on a clock that ticks one second a reading, leaves
equal accumulators and hit counts in both; reset also clears the port's
event counts."""

import time

import pytest

from fgdp_tpu.utils import profiling as jprof
from fgdp_tpu_torch.utils import profiling as prof


def _drive(p):
    """A sequence of calls; the (acc, hits) seen after each step."""
    seen = []

    def look():
        seen.append((dict(p.acc), dict(p.hits)))

    with p.phase("READ_IO"):
        pass
    look()
    p.add("WORKER_SAM", 0.25)
    p.add("WORKER_SAM", 0.5)
    with p.phase("READ_IO"):
        with p.phase("SAM_IO"):
            pass
    look()
    p.reset()
    look()
    p.add("HMM_F64", 0.68)
    with p.phase("WORKER_SAM"):
        pass
    look()
    return seen


@pytest.fixture
def ticking_clock(monkeypatch):
    def install():
        t = iter(range(10_000))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(t)))
    return install


def test_profiler_matches_fgdp_tpu(ticking_clock):
    ticking_clock()
    ours = _drive(prof.Profiler())
    ticking_clock()
    theirs = _drive(jprof.Profiler())
    assert ours == theirs
    assert ours[2] == ({}, {})
    assert ours[-1] == ({"HMM_F64": 0.68, "WORKER_SAM": 1.0},
                        {"HMM_F64": 1, "WORKER_SAM": 1})


def test_reset_clears_counts():
    p = prof.Profiler()
    p.count(prof.HMM_F64, 70)
    p.add(prof.HMM_WAIT, 1.5)
    p.reset()
    assert not p.counts and not p.acc and not p.hits
    p.count(prof.HMM_F64)
    assert p.counts[prof.HMM_F64] == 1
