"""The device program's CUDA graphs (pipeline._GraphRunner): on the CPU a
dispatch builds no graph and counts nothing, and the runner's pieces that
need no card (the launch tally under a capture, a replay's fold) keep
their contracts; on the card (marked `cuda`) a replayed dispatch's packed
reg buffer equals the op-by-op program's bit for bit, at the primary
shape, a short last batch and every rung flavor at both levels, on both
seeding engines, with keys interleaved and four primaries in flight; the
counts add up to the dispatches, a replay's kernel events fold into
kernels.TIMED one entry a launch, and a failed capture leaves its shape
running op by op.

This file imports neither jax nor fgdp_tpu, so it also runs on the card's
machine without the conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_graphs.py
"""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fgdp_tpu_torch.config import BatchShapes
from fgdp_tpu_torch.index.fmindex import FMIndex
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.io.fastq import parse_fastq_records
from fgdp_tpu_torch.ops import kernels
from fgdp_tpu_torch.pipeline import (STAGES, Aligner, _Replay,
                                     device_align_packed, unpack_regs)
from fgdp_tpu_torch.utils import dna
from fgdp_tpu_torch.utils.profiling import PROF

HERE = os.path.join(os.path.dirname(__file__), "golden")
# chip_smoke.py's ladder caps: most reads climb every rung
SHAPES = BatchShapes(read_len=100, batch_reads=64, max_smems=1,
                     max_seeds=8, max_chains=2, max_regs=3,
                     transfer_regs=2, pack_cap=1, max_ext_ref=304)
DP = ("DP_REPLAY", "DP_CAPTURE", "DP_EAGER")
RUNGS = [(fl, lv) for fl in ("k2w", "cw", "full") for lv in (1, 2)]
SWEEP_KERNELS = ("sweep_fwd", "sweep_bwd", "chain_flt", "chain_loop",
                 "sw_extend")
LCP_KERNELS = ("smem_lcp", "k2_lcp", "seed_strategy", "chain_flt",
               "chain_loop", "sw_extend")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pref():
    return PackedReference.from_fasta(os.path.join(HERE, "rep_ref.fa"))


@pytest.fixture(scope="module")
def fm(pref):
    return FMIndex.build(pref.codes)


@pytest.fixture(scope="module")
def seqs():
    recs = parse_fastq_records(os.path.join(HERE, "rep.fq"))
    return [dna.encode(r[2]).astype(np.int64) for r in recs]


def counts():
    return {k: PROF.counts[k] for k in DP}


def stage(al, shapes, reads):
    """A staging of `reads` (the first rows; the rest inactive)."""
    st = al._graphs.inputs(shapes)
    st.codes.fill(4)
    st.lens.fill(0)
    st.active.fill(False)
    for j, s in enumerate(reads):
        n = min(len(s), shapes.read_len)
        st.codes[j, :n] = s[:n]
        st.lens[j] = n
        st.active[j] = True
    return st


def dispatch(al, shapes, reads):
    return al._run(stage(al, shapes, reads), None)


def case_shapes(al):
    """(name, shapes, reads a dispatch): the primary, a short last batch
    and every rung flavor at both levels, chunks of 128 lanes."""
    out = [("primary", SHAPES, 64),
           ("short", dataclasses.replace(SHAPES, batch_reads=40), 40)]
    out += [(f"{fl}{lv}", al._rung_shapes(fl, lv, 128), 100)
            for fl, lv in RUNGS]
    return out


# ---- the CPU ------------------------------------------------------------

@pytest.mark.parametrize("case", ["primary", "short", "cw1", "full2"])
def test_cpu_dispatch_runs_the_program_op_by_op(pref, fm, seqs, case):
    """On the CPU a dispatch through the runner gives the program's own
    buffer, builds no graph and counts no replay, capture or eager
    dispatch."""
    al = Aligner(pref, fm, shapes=SHAPES, lcp=False, device="cpu")
    _, shapes, n = {c[0]: c for c in case_shapes(al)}[case]
    reads = seqs[:n]
    c0 = counts()
    got = al._fetch(dispatch(al, shapes, reads))
    st = stage(al, shapes, reads)
    want = device_align_packed(
        al.dfm, al.dref, torch.as_tensor(st.codes).to(torch.int32),
        torch.as_tensor(st.lens), torch.as_tensor(st.active),
        opt=al._dev_opt, shapes=shapes).numpy()
    assert np.array_equal(got, want)
    assert unpack_regs(got)["valid"].shape[0] == shapes.batch_reads
    assert counts() == c0 and not al._graphs.programs
    assert not al._clocks


def test_cpu_ladder_counts_no_graph(pref, fm, seqs):
    """The whole ladder on the CPU: rungs run, and no dispatch counts as
    replayed, captured or eager."""
    al = Aligner(pref, fm, shapes=SHAPES, device="cpu")
    c0 = counts()
    al._device_regs(seqs[:64])
    assert al.esc_calls > 0
    assert counts() == c0 and not al._graphs.programs


def test_pack_header_is_set_on_the_device(pref, fm, seqs):
    """pack_regs' header words E, B, now filled on the device."""
    al = Aligner(pref, fm, shapes=SHAPES, lcp=False, device="cpu")
    buf = al._fetch(dispatch(al, SHAPES, seqs[:10]))
    assert buf.dtype == np.int32
    assert (int(buf[0]), int(buf[1])) == (SHAPES.transfer_regs, 64)


def test_launches_under_a_capture_wait_for_the_replays():
    """kernels.tally counts at once outside a capture; under one it keeps
    the launch for the replays, and kernels.event_pair asks nothing of
    the card when no caller times the kernel."""
    key = "sw_extend"
    n0 = kernels.LAUNCHES[key]
    kernels.tally(kernels.LAUNCHES, key)
    assert kernels.LAUNCHES[key] == n0 + 1
    cap = kernels.Capture()
    kernels.CAPTURE = cap
    try:
        kernels.tally(kernels.LAUNCHES, key)
    finally:
        kernels.CAPTURE = None
    assert kernels.LAUNCHES[key] == n0 + 1
    assert cap.counts == [(kernels.LAUNCHES, key)]
    assert kernels.TIMED.get("no_such_kernel") is None
    assert kernels.event_pair("no_such_kernel", None) == [None, None]
    assert kernels.event_ptrs([None, None]) == (None, None)


class _At:
    """A stand-in CUDA event at a fixed time (ms)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_a_replay_folds_stage_spans_and_one_entry_a_launch():
    """_Replay.fold adds the program's stage spans to the dict, and one
    TIMED entry a captured launch of a kernel timed at the replay, whose
    `s.elapsed_time(e)` is that launch's ms (as the benchmark sums
    them); kernels not timed then get none."""
    cap = kernels.Capture()
    cap.timed = [("sw_extend", _At(1.0), _At(1.5)),
                 ("sw_extend", _At(2.0), _At(2.25)),
                 ("chain_loop", _At(3.0), _At(4.0))]
    marks = [(None, _At(0.0))] + [(s, _At(float(i + 1)))
                                  for i, s in enumerate(STAGES)]
    prog = SimpleNamespace(launches=cap, marks=marks, unfolded=None)
    acc = {}
    old = kernels.TIMED.pop("sw_extend", None), \
        kernels.TIMED.pop("chain_loop", None)
    kernels.TIMED["sw_extend"] = []
    try:
        rep = _Replay(prog, acc)
        prog.unfolded = rep
        assert rep
        rep.fold()
        got = [s.elapsed_time(e) for s, e in kernels.TIMED["sw_extend"]]
    finally:
        kernels.TIMED.pop("sw_extend", None)
        for k, v in zip(("sw_extend", "chain_loop"), old):
            if v is not None:
                kernels.TIMED[k] = v
    assert got == [0.5, 0.25]
    assert acc == {s: 1.0 for s in STAGES}
    assert prog.unfolded is None
    assert not _Replay(prog, None)


# ---- the card -----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def eager(al, shapes, reads):
    al._graphs._force_eager = True
    try:
        return al._fetch(dispatch(al, shapes, reads))
    finally:
        al._graphs._force_eager = False


@pytest.mark.cuda
@pytest.mark.parametrize("lcp", [False, True], ids=["sweep", "lcp"])
def test_replay_equals_eager_at_every_shape(dev, pref, fm, seqs, lcp):
    """Each shape: its capturing dispatch, a replay on the same reads and
    a replay on other reads give the op-by-op program's buffers, bit for
    bit."""
    al = Aligner(pref, fm, shapes=SHAPES, lcp=lcp, device=dev)
    cases = case_shapes(al)
    c0 = counts()
    for name, shapes, n in cases:
        a, b = seqs[:n], seqs[-n:]
        want_a, want_b = eager(al, shapes, a), eager(al, shapes, b)
        for reads, want, what in ((a, want_a, "capture"),
                                  (a, want_a, "replay"),
                                  (b, want_b, "replay, other reads")):
            got = al._fetch(dispatch(al, shapes, reads))
            assert np.array_equal(got, want), (name, what)
    d = {k: PROF.counts[k] - c0[k] for k in DP}
    assert d == {"DP_REPLAY": 2 * len(cases), "DP_CAPTURE": len(cases),
                 "DP_EAGER": 2 * len(cases)}


@pytest.mark.cuda
def test_interleaved_keys_with_four_primaries_in_flight(dev, pref, fm,
                                                       seqs):
    """Two shapes' dispatches interleaved, four primaries in flight before
    any fetch: each replay's buffer is its own (the per-dispatch output
    buffers) and the shared pool holds both graphs."""
    al = Aligner(pref, fm, shapes=SHAPES, lcp=False, device=dev)
    short = dataclasses.replace(SHAPES, batch_reads=40)
    plan = [(SHAPES, 0), (short, 7), (SHAPES, 64), (SHAPES, 128),
            (short, 150), (SHAPES, 166)]
    want = [eager(al, sh, seqs[i:i + sh.batch_reads]) for sh, i in plan]
    for sh in (SHAPES, short):                 # capture both
        al._fetch(dispatch(al, sh, seqs[:sh.batch_reads]))
    c0 = counts()
    inflight = [dispatch(al, sh, seqs[i:i + sh.batch_reads])
                for sh, i in plan]
    got = [al._fetch(d) for d in inflight]
    assert PROF.counts["DP_REPLAY"] - c0["DP_REPLAY"] == len(plan)
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), k


@pytest.mark.cuda
def test_dp_counts_add_up_to_the_dispatches(dev, pref, fm, seqs):
    """Over whole batches with their ladders (first pass: captures, then
    replays; a pass op by op), DP_REPLAY + DP_CAPTURE + DP_EAGER is the
    number of dispatches, and the SAM lines are the same each pass."""
    al = Aligner(pref, fm, shapes=SHAPES, lcp=False, device=dev)
    inner, calls = al._run, []

    def run(*a):
        calls.append(1)
        return inner(*a)

    al._run = run
    names = [f"r{i}" for i in range(64)]
    c0 = counts()
    sam = [al.align_batch(names, seqs[:64]) for _ in range(3)]
    al._graphs._force_eager = True
    sam.append(al.align_batch(names, seqs[:64]))
    al._graphs._force_eager = False
    d = {k: PROF.counts[k] - c0[k] for k in DP}
    assert sum(d.values()) == len(calls)
    assert min(d.values()) > 0 and al.esc_calls > 0
    assert sam[1] == sam[0] and sam[2] == sam[0] and sam[3] == sam[0]


@pytest.mark.cuda
@pytest.mark.parametrize("lcp", [False, True], ids=["sweep", "lcp"])
def test_traced_replays_fold_one_entry_a_launch(dev, pref, fm, seqs, lcp):
    """With every kernel of the path timed and the stage clock on, the
    folded TIMED entries of each kernel match its LAUNCHES over runs
    that capture and then replay, every entry's ms is positive, and the
    stage clock has every stage."""
    names = LCP_KERNELS if lcp else SWEEP_KERNELS
    al = Aligner(pref, fm, shapes=SHAPES, lcp=lcp, device=dev)
    al._device_regs(seqs[-64:])          # capture the shapes it meets
    l0 = dict(kernels.LAUNCHES)
    c0 = counts()
    old = {k: kernels.TIMED.pop(k, None) for k in names}
    for k in names:
        kernels.TIMED[k] = []
    al.stage_ms, al.esc_stage_ms = {}, {}
    try:
        for _ in range(2):
            al._device_regs(seqs[-64:])
        timed = {k: kernels.TIMED[k] for k in names}
    finally:
        for k, v in old.items():
            kernels.TIMED.pop(k, None)
            if v is not None:
                kernels.TIMED[k] = v
    assert PROF.counts["DP_REPLAY"] - c0["DP_REPLAY"] > 0
    assert not al._clocks
    for k in names:
        n = kernels.LAUNCHES[k] - l0[k]
        assert n > 0 and len(timed[k]) == n, (k, n, len(timed[k]))
        assert all(s.elapsed_time(e) > 0 for s, e in timed[k]), k
    assert set(al.stage_ms) == set(STAGES) and al.stage_ms["seed"] > 0
    assert set(al.esc_stage_ms) == set(STAGES)


_FAILED_CAPTURE = """
import dataclasses, json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import test_torch_graphs as t
from fgdp_tpu_torch.pipeline import Aligner, _GraphRunner

pref = t.PackedReference.from_fasta(t.os.path.join(t.HERE, "rep_ref.fa"))
fm = t.FMIndex.build(pref.codes)
seqs = [t.dna.encode(r[2]).astype(np.int64)
        for r in t.parse_fastq_records(t.os.path.join(t.HERE, "rep.fq"))]
al = Aligner(pref, fm, shapes=t.SHAPES, lcp=False, device="cuda")
short = dataclasses.replace(t.SHAPES, batch_reads=40)
cw1 = al._rung_shapes("cw", 1, 128)
cases = [(t.SHAPES, 64), (short, 40), (cw1, 100)]
want = [t.eager(al, sh, seqs[:n]) for sh, n in cases]
c0 = t.counts()
steps = []
got = lambda sh, n: t.np.array_equal(
    al._fetch(t.dispatch(al, sh, seqs[:n])), want[cases.index((sh, n))])
steps.append(got(short, 40))                   # captures
real = torch.cuda.is_current_stream_capturing
torch.cuda.is_current_stream_capturing = lambda: False
steps.append(got(t.SHAPES, 64))                # its capture fails
torch.cuda.is_current_stream_capturing = real
steps += [got(t.SHAPES, 64), got(short, 40), got(cw1, 100)]
d = {k: t.PROF.counts[k] - c0[k] for k in t.DP}
print(json.dumps(dict(steps=steps, counts=d,
                      failed=_GraphRunner._capture_failed,
                      eager=al._graphs.programs[t.SHAPES].eager)))
"""


@pytest.mark.cuda
def test_failed_capture_runs_op_by_op(dev):
    """A capture that raises (here: P1's check reads the card inside it)
    leaves its shape op by op, and the shapes not captured yet, each
    dispatch counted DP_EAGER with the op-by-op buffer; a shape captured
    before still replays. In a process of its own: the failure leaves
    state behind in torch."""
    import json
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE, here],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(here))
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["steps"] == [True] * 5, out
    assert out["failed"] and out["eager"]
    assert out["counts"] == {"DP_REPLAY": 1, "DP_CAPTURE": 1,
                             "DP_EAGER": 3}, out
