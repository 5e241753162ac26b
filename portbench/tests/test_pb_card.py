"""The benchmark on the card: one short run of each cell, correct, with
the result line's keys; the paired-end cell with its ladder off, not
correct; the single-end cell's ladder fault beside its witness. Skips
without a card (decided in the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import pb_common as pc


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(script, cell):
    p = subprocess.run([sys.executable, script, "--workload", cell,
                        "--seed", str(2 ** 31 + 99), "--seconds", "5",
                        "--trace", "0"], cwd=pc.REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["chr20-pe-mem", "chr20-somatic"])
def test_cell_runs_correct(card, cell):
    """The listed cell, and chr20-somatic, built but not yet in
    BENCHMARK.json (its rate is not steady: PERF.md)."""
    line = _run("portbench/run.py", cell)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0
    assert "setup_s" in line["metrics"]


@pytest.mark.cuda
def test_single_end_ladder_fault_and_its_witness(card):
    """ecoli-se-pipeline is left out of BENCHMARK.json: the port's
    escalation ladder reports unmapped reads that its primary pass
    placed (PERF.md, Open questions). The same run with the ladder off,
    the program's other path, places them: its unmapped share is within
    the cell's limit, the run as configured is over it. A program whose
    ladder is repaired reads within the limit in both."""
    on = _run("portbench/run.py", "ecoli-se-pipeline")["checks"]
    off = _run("portbench/lib/ladder_off.py", "ecoli-se-pipeline")["checks"]
    assert off["unmapped_pct"]["value"] <= off["unmapped_pct"]["limit"]
    assert on["unmapped_pct"]["value"] > on["unmapped_pct"]["limit"]


@pytest.mark.cuda
def test_ladder_off_fails_the_paired_end_cell(card):
    """The program's own cheaper path, its escalation ladder switched
    off, leaves more reads unmapped than the cell's limit."""
    line = _run("portbench/lib/ladder_off.py", "chr20-pe-mem")
    assert not line["correct"]
    c = line["checks"]["unmapped_pct"]
    assert c["value"] > c["limit"]
