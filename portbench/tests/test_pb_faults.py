"""Faults planted under a run: the harness's look for a card skipped
(the CPU in its place) and the rest of a run driven on tiny cells, with
the timed path broken underneath. Each fault the cell can have must turn
`correct` false; the sound run must read true. (One card: no exchange
between cards to leave out.) About ten minutes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

import pb_common as pc


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = pc.checkout(tmp_path_factory.mktemp("faults"))
    pc.add_tiny_cells(r)
    return r


def _half(lines):
    """Half of the batch left out: the records of every second read."""
    names = sorted({ln.split("\t", 1)[0] for ln in lines})
    drop = set(names[::2])
    return [ln for ln in lines if ln.split("\t", 1)[0] not in drop]


def _moved(lines):
    """An answer altered where it is produced: the first mapped record's
    position one base on."""
    out, done = [], False
    for ln in lines:
        f = ln.split("\t")
        if not done and not int(f[1]) & 4:
            f[3] = str(int(f[3]) + 1)
            done = True
        out.append("\t".join(f))
    return out


def _unmapped(lines):
    """Answers altered where they are produced: every read reported
    unmapped (its primary record kept as the read, strand and SEQ, its
    other records dropped), so that only the unmapped share sees it."""
    out = []
    for ln in lines:
        f = ln.split("\t")
        if int(f[1]) & 0x900:
            continue
        f[1] = str(int(f[1]) & ~0x2 | 0x4)
        f[2:6] = ["*", "0", "0", "*"]
        out.append("\t".join(f[:11]))
    return out


def _collect_through(fn):
    from fgdp_tpu_torch.pipeline_stream import FinalizePool
    inner = FinalizePool.__dict__["collect"].__func__
    return staticmethod(lambda fut: fn(inner(fut)))


def _unsorted(ucoord, valid):
    """The sort returning its input as it came."""
    import torch
    return torch.arange(ucoord.shape[0], device=ucoord.device)


def _no_dups(*a, **kw):
    """Duplicate marking returning its state unchanged (nothing
    flagged)."""
    import torch
    return (torch.zeros(a[0].shape[0], dtype=torch.bool),
            torch.zeros(a[8].shape[0], dtype=torch.bool))


def _hmm_through(fn):
    """The PairHMM launch's answers, changed where they are produced."""
    from fgdp_tpu_torch.ops import pairhmm
    inner = pairhmm.compute_log_likelihoods_async

    def launch(*a, **kw):
        collect = inner(*a, **kw)
        return lambda: fn(collect())
    return launch


def _hmm_half(out):
    """Half of the batch left out: every second pair's likelihood never
    computed (left at 0)."""
    out = out.copy()
    out[::2] = 0.0
    return out


def _hmm_moved(out):
    """Answers altered where they are produced: every likelihood of the
    launch off by 10% (0.041 in log10), as a kernel that lost precision
    would give."""
    return out + np.log10(1.1)


FAULTS = {
    "half_left_out": ("collect", _half),
    "answer_altered": ("collect", _moved),
    "all_unmapped": ("collect", _unmapped),
    "sort_unchanged": ("sort", _unsorted),
    "dups_unchanged": ("dups", _no_dups),
    "hmm_half_left_out": ("hmm", _hmm_half),
    "hmm_answer_altered": ("hmm", _hmm_moved),
}
CELLS = {"tiny-ecoli-se-pipeline": ["half_left_out", "answer_altered",
                                    "all_unmapped", "sort_unchanged",
                                    "dups_unchanged"],
         "tiny-chr20-pe-mem": ["half_left_out", "answer_altered",
                               "all_unmapped"],
         "tiny-chr20-somatic": ["hmm_half_left_out", "hmm_answer_altered"]}


def _run(root, cell, seed):
    return pc.run_cpu(root, ["--workload", cell, "--seed", str(seed),
                             "--seconds", "600", "--trace", "0"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, cell):
    rc, line, err = _run(root, cell, 2 ** 31 + 5)
    assert rc == 0, err
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in sorted(CELLS) for f in CELLS[c]])
def test_fault_turns_correct_false(root, cell, fault, monkeypatch):
    from fgdp_tpu_torch import pipeline_stream
    from fgdp_tpu_torch.ops import pairhmm
    from fgdp_tpu_torch.sortdup import driver, engine
    where, fn = FAULTS[fault]
    if where == "collect":
        monkeypatch.setattr(pipeline_stream.FinalizePool, "collect",
                            _collect_through(fn))
    elif where == "hmm":
        monkeypatch.setattr(pairhmm, "compute_log_likelihoods_async",
                            _hmm_through(fn))
    elif where == "sort":
        monkeypatch.setattr(engine, "coordinate_sort_order", fn)
    else:
        monkeypatch.setattr(driver.engine, "mark_duplicates", fn)
    rc, line, err = _run(root, cell, 2 ** 31 + 5)
    assert rc == 0, err
    assert not line["correct"], line["checks"]
