"""The window's arithmetic: the input is passed on until the deadline,
everything fed counts, the time runs to the close after the drain, and
an input that runs out ends the window early."""

from __future__ import annotations

import sys
import time

import pb_common as pc

sys.path.insert(0, pc.BENCH)

from lib.harness import Window  # noqa: E402


def _batches(n, dt):
    for i in range(n):
        time.sleep(dt)
        yield [i] * 10


def test_all_work_over_all_the_time_with_the_drain():
    w = Window(0.3)
    w.open()
    got = sum(len(b) for b in w.feed(_batches(1000, 0.02), len))
    time.sleep(0.2)                       # the drain after the input ends
    w.close()
    assert not w.ran_dry
    assert got == w.fed and 100 <= w.fed <= 200
    assert 0.5 <= w.length < 0.7
    rate = w.fed / w.length
    assert rate < w.fed / 0.3


def test_input_that_runs_out_ends_the_window():
    w = Window(30.0)
    w.open()
    got = sum(len(b) for b in w.feed(_batches(5, 0.01), len))
    w.close()
    assert w.ran_dry and got == w.fed == 50
    assert w.length < 1.0
