"""The reader of device_program.replay_share: the share of the card
dispatches of the device program that replayed a captured CUDA graph,
from the port's counts DP_REPLAY, DP_CAPTURE and DP_EAGER, and None
where the run counts none of them (the CPU, or a program without the
graph runner)."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import pb_common as pc

sys.path.insert(0, pc.BENCH)

from lib import harness  # noqa: E402


def stub(prof_counts=()):
    return SimpleNamespace(prof_delta={}, prof_counts=dict(prof_counts),
                           counters={"esc_reads": 140_000},
                           window_len=50.0, work=200_000, kreads=200.0)


def read(t):
    return harness.load_module("metrics",
                               "device_program.replay_share").read(t)


@pytest.mark.parametrize("counts,share", [
    ({"DP_REPLAY": 1_900, "DP_CAPTURE": 60, "DP_EAGER": 40}, 95.0),
    ({"DP_REPLAY": 12}, 100.0),
    ({"DP_CAPTURE": 3, "DP_EAGER": 1}, 0.0),
])
def test_replay_share_value(counts, share):
    assert read(stub(counts)) == pytest.approx(share)


@pytest.mark.parametrize("counts", [
    {},
    {"DP_REPLAY": 0, "DP_CAPTURE": 0, "DP_EAGER": 0},
    {"ESC_ACTIVE": 96_000, "ESC_LANES": 128_000},
])
def test_replay_share_absent(counts):
    assert read(stub(counts)) is None
