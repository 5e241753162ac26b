"""The readers of the port's own spans and counters: each gives its
value from a stub of the traced run's record and None where the run
holds none of its inputs (a program that does not record them)."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import pb_common as pc

sys.path.insert(0, pc.BENCH)

from lib import harness  # noqa: E402

WINDOW = 50.0
READS = 200_000


def stub(prof_delta=(), prof_counts=(), counters=()):
    return SimpleNamespace(prof_delta=dict(prof_delta),
                           prof_counts=dict(prof_counts),
                           counters=dict(counters), window_len=WINDOW,
                           work=READS, kreads=READS / 1e3)


FULL = stub(
    prof_delta={"ESC_PACK": 3.0, "ESC_MERGE": 2.0, "ESC_DISPATCH": 4.0,
                "MEM_DEVICE": 7.0, "DP_SYNC": 6.0, "POOL_WAIT": 1.5,
                "POOL_WORK": 120.0},
    prof_counts={"ESC_ACTIVE": 96_000, "ESC_LANES": 128_000,
                 "ESC_UNRESOLVED": 14_000},
    counters={"esc_reads": 140_000})

CASES = {
    "ladder.host_share": 100.0 * 5.0 / WINDOW,
    "ladder.lane_fill": 75.0,
    "ladder.unresolved_share": 10.0,
    "device_program.enqueue_share": 100.0 * 5.0 / WINDOW,
    "device_program.sync_wait_share": 100.0 * 6.0 / WINDOW,
    "stream.collect_wait_share": 3.0,
    "pool.work_ms_per_kread": 600.0,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_value_and_absence(name):
    read = harness.load_module("metrics", name).read
    assert read(FULL) == pytest.approx(CASES[name])
    # the parent's program records none of these phases and counts
    assert read(stub(counters={"esc_reads": 140_000})) is None
