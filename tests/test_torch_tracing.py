"""The port's own spans and counters (utils/profiling.PROF): phase
nesting and self time, the `fgdp.<PHASE>` annotations under a torch
profiler, the escalation ladder's phases and counts, the stage clock,
and the finalize pool's phases.

The last test needs the card (marked `cuda`): every wait of the host for
the card inside a dispatch goes through host_read, the stage clock adds
none, and a replayed dispatch has none. This file imports neither jax nor fgdp_tpu, so it also runs
on the card's machine without the conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_tracing.py
"""

import io
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from fgdp_tpu_torch import cli
from fgdp_tpu_torch.config import BatchShapes
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.pipeline import STAGES, Aligner
from fgdp_tpu_torch.pipeline_stream import FinalizePool, stream_mem_pooled
from fgdp_tpu_torch.utils import profiling
from fgdp_tpu_torch.utils.profiling import DP_SYNC, PROF, Profiler

HERE = os.path.join(os.path.dirname(__file__), "golden")
REF = os.path.join(HERE, "ref.fa")
# tests/test_torch_pipeline.py's caps: four transfer slots a read make
# reads overflow and climb the ladder
BATCH = 32
TIGHT = dict(batch_reads=BATCH, transfer_regs=4)
LADDER = ("ESC_PACK", "ESC_DISPATCH", "ESC_FETCH", "ESC_MERGE")
COUNTS = ("ESC_ACTIVE", "ESC_LANES", "ESC_UNRESOLVED", DP_SYNC)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def se_batches():
    return list(cli.read_batches([os.path.join(HERE, "se.fq")], BATCH))


@pytest.fixture(scope="module")
def pref():
    return PackedReference.from_fasta(REF)


@pytest.fixture(scope="module")
def fm(pref):
    return FMIndex.build(pref.codes)


def ticking(monkeypatch):
    t = iter(range(10_000))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(t)))


def test_nested_phases_keep_self_time(monkeypatch):
    """A phase's self time leaves out the phases opened inside it; the
    inclusive accumulators stay as they were, and the report's TOTAL
    counts the outermost phase's time once, and what was added."""
    p = Profiler()
    ticking(monkeypatch)
    with p.phase("REG_SYNC"):                 # 0 .. 7
        with p.phase("ESC_RETRY"):            # 1 .. 6
            with p.phase("ESC_PACK"):         # 2 .. 3
                pass
            p.add("POOL_WORK", 0.5)           # no clock, no child time
            with p.phase("ESC_FETCH"):        # 4 .. 5
                pass
    assert dict(p.acc) == {"REG_SYNC": 7.0, "ESC_RETRY": 5.0,
                           "ESC_PACK": 1.0, "ESC_FETCH": 1.0,
                           "POOL_WORK": 0.5}
    assert dict(p.self_acc) == {"REG_SYNC": 2.0, "ESC_RETRY": 3.0,
                                "ESC_PACK": 1.0, "ESC_FETCH": 1.0,
                                "POOL_WORK": 0.5}
    out = io.StringIO()
    p.display_stats(out=out)
    total = [ln for ln in out.getvalue().splitlines() if "TOTAL" in ln]
    assert float(total[0].split()[1].rstrip("s")) == 7.5
    p.reset()
    assert not p.self_acc and not p.acc


def test_phases_of_other_threads_are_not_children():
    """Each thread keeps its own stack of open phases: a phase on another
    thread while one is open here takes nothing from its self time."""
    p = Profiler()
    done = threading.Event()

    def other():
        with p.phase("SAM_IO"):
            time.sleep(0.05)
        done.set()

    with p.phase("POOL_WAIT"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive() and done.is_set()
    assert p.self_acc["POOL_WAIT"] == p.acc["POOL_WAIT"]
    assert p.self_acc["SAM_IO"] == p.acc["SAM_IO"] >= 0.05


def test_annotations_only_under_a_profiler(monkeypatch):
    """Under torch.profiler a phase is a `fgdp.<PHASE>` annotation;
    without one, no record_function is entered."""
    p = Profiler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with p.phase("ESC_DISPATCH"):
            profiling.host_read(int, torch.arange(5).sum())
    names = {e.name for e in prof.events()}
    assert {"fgdp.ESC_DISPATCH", "fgdp.DP_SYNC"} <= names

    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    n0 = PROF.counts[DP_SYNC]
    with p.phase("MEM_DEVICE"):
        assert profiling.host_read(int, torch.tensor(7)) == 7
    assert PROF.counts[DP_SYNC] == n0 + 1 and p.hits["MEM_DEVICE"] == 1


def test_ladder_records_its_phases_and_counts(pref, fm, se_batches):
    al = Aligner(pref, fm, shapes=BatchShapes(**TIGHT), device="cpu")
    acc0, hits0 = dict(PROF.acc), dict(PROF.hits)
    c0 = {k: PROF.counts[k] for k in COUNTS}
    for names, seqs, quals in se_batches:
        al._device_regs(seqs)
    esc = al.esc_reads
    assert esc > 0 and al.esc_calls > 0
    d = {k: PROF.counts[k] - c0[k] for k in COUNTS}
    assert d["ESC_LANES"] >= d["ESC_ACTIVE"] >= esc
    assert d["ESC_LANES"] % 128 == 0
    assert 0 <= d["ESC_UNRESOLVED"] <= esc
    assert d[DP_SYNC] > 0
    for k in LADDER:
        assert PROF.hits[k] - hits0.get(k, 0) > 0, k
    rungs = PROF.hits["ESC_DISPATCH"] - hits0.get("ESC_DISPATCH", 0)
    assert rungs == al.esc_calls
    assert PROF.hits["ESC_FETCH"] - hits0.get("ESC_FETCH", 0) == rungs
    assert PROF.hits["ESC_MERGE"] - hits0.get("ESC_MERGE", 0) == rungs
    whole = PROF.acc["ESC_RETRY"] - acc0.get("ESC_RETRY", 0.0)
    parts = sum(PROF.acc[k] - acc0.get(k, 0.0) for k in LADDER)
    assert 0 < parts <= whole


def test_stage_clock_leaves_sam_unchanged(pref, fm, se_batches):
    """The same SAM lines with the stage clock on and off; on the CPU the
    clock adds each stage's host time as it ends."""
    names, seqs, quals = se_batches[1]
    al = Aligner(pref, fm, shapes=BatchShapes(**TIGHT), device="cpu")
    off = al.align_batch(names, seqs, quals)
    al.stage_ms, al.esc_stage_ms = {}, {}
    on = al.align_batch(names, seqs, quals)
    assert on == off
    assert set(al.stage_ms) == set(STAGES)
    assert set(al.esc_stage_ms) == set(STAGES)
    assert all(v >= 0 for v in al.stage_ms.values())
    assert not al._clocks


def test_pool_records_wait_and_work(pref, fm, se_batches, tmp_path):
    """stream_mem_pooled with two workers: POOL_SUBMIT and POOL_WAIT a
    batch, and the workers' own seconds under POOL_WORK."""
    pref.save(str(tmp_path / "idx.ref"))
    al = Aligner(pref, fm, shapes=BatchShapes(batch_reads=BATCH),
                 device="cpu")
    hits0 = {k: PROF.hits[k] for k in ("POOL_SUBMIT", "POOL_WAIT",
                                       "POOL_WORK")}
    work0 = PROF.acc["POOL_WORK"]
    lines = []
    pool = FinalizePool(str(tmp_path / "idx.ref"), al.opt, 2)
    try:
        n = stream_mem_pooled(al, iter(se_batches), lines.append, pool)
    finally:
        pool.shutdown()
    assert n == sum(len(b[0]) for b in se_batches) and len(lines) >= n
    for k, h in hits0.items():
        assert PROF.hits[k] - h == len(se_batches), k
    assert PROF.acc["POOL_WORK"] > work0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lcp", [False, True], ids=["sweep", "lcp"])
def test_card_waits_are_all_counted(dev, lcp):
    """Under torch.cuda.set_sync_debug_mode("warn"), with the stage clock
    on, each dispatch of the device program (a primary batch's and every
    rung's, from its start up to its fetch) warns of as many syncs as
    DP_SYNC counts: every wait of the host for the card there goes
    through host_read, and the stage clock adds none. A dispatch that
    captures its shape, or runs op by op, waits (P1's check of its query
    lengths, a host_read); a replayed one warns of none and counts
    none."""
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.utils import dna

    pref = PackedReference.from_fasta(os.path.join(HERE, "rep_ref.fa"))
    recs = list(parse_fastq_records(os.path.join(HERE, "rep.fq")))
    seqs = [dna.encode(r[2]).astype(np.int64) for r in recs]
    al = Aligner(pref, FMIndex.build(pref.codes),
                 shapes=BatchShapes(batch_reads=128, transfer_regs=2),
                 lcp=lcp, device=dev)
    inner = al._run
    seen = []

    def run(*a):
        n0 = PROF.counts[DP_SYNC]
        r0 = PROF.counts["DP_REPLAY"]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                buf = inner(*a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("called a synchronizing CUDA operation"
                    in str(x.message) for x in w)
        replayed = PROF.counts["DP_REPLAY"] > r0
        seen.append((replayed, syncs, PROF.counts[DP_SYNC] - n0))
        return buf

    al._run = run
    al.stage_ms, al.esc_stage_ms = {}, {}
    for force_eager in (False, False, True):   # capture, replay, op by op
        al._graphs._force_eager = force_eager
        esc0, n0 = al.esc_calls, len(seen)
        al._device_regs(seqs)
        assert al.esc_calls > esc0
        assert len(seen) - n0 == 1 + al.esc_calls - esc0
    al._graphs._force_eager = False
    assert any(r for r, _, _ in seen) and not all(r for r, _, _ in seen)
    assert all(s == d == 0 for r, s, d in seen if r), seen
    assert all(s == d > 0 for r, s, d in seen if not r), seen
    assert set(al.stage_ms) == set(STAGES) and al.stage_ms["seed"] > 0
    assert set(al.esc_stage_ms) == set(STAGES)
