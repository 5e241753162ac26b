"""The port's CNN gate (call/cnn_filter.py) against the JAX package's: the
feature builder on tests/test_cnn_gate.py's cases and on seeded reads
with insertions, deletions and soft clips, the scan's skip order, the
keep/drop decisions of test-built TorchScript models (one of them
reaches exactly 1.0 on some inputs, the only float32 output above the
threshold), and `mutect --deep-model` through both CLIs on the 120x
fixture tests/golden/mutect_cnn (the gate fires only in regions of more
than 100 tumor reads, which tests/golden/mutect does not have), with
`-t 2` equal to `-t 1`."""

import pathlib

import numpy as np
import pytest

from fgdp_tpu.call import cnn_filter as jcf
from fgdp_tpu_torch.call import cnn_filter as cf

from test_cnn_gate import mk_read
from test_torch_bqsr import run_both_clis, same_vcf
from test_torch_cuda import gate_model
from test_torch_seeding import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
CNN_FIX = ROOT / "tests" / "golden" / "mutect_cnn"
# seed 2 at scale 400: exactly 1.0 on two of mutect_cnn's five gated
# variants, clearly below it on the other three
MODEL = dict(seed=2, scale=400.0)


def seeded_reads(seed, n=80, lo=60, hi=140):
    """Reads over [lo, hi) with soft clips, insertions (some anchored at
    the window's first column), deletions and N bases."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        p = int(rng.integers(lo - 40, hi - 10))
        ln = int(rng.integers(20, 70))
        cig = [(0, ln)]
        r = rng.random()
        if r < 0.25:
            a = int(rng.integers(1, ln))
            cig = [(0, a), (1, int(rng.integers(1, 5))), (0, ln - a)]
        elif r < 0.45:
            a = int(rng.integers(1, ln))
            cig = [(0, a), (2, int(rng.integers(1, 6))), (0, ln - a)]
        elif r < 0.55:
            cig = [(0, 10), (1, 3), (0, 10), (2, 2), (0, ln)]
        if rng.random() < 0.3:
            cig = [(4, int(rng.integers(1, 8)))] + cig
        if rng.random() < 0.2:
            cig = cig + [(4, int(rng.integers(1, 8)))]
        qlen = sum(l for op, l in cig if op in (0, 1, 4, 7, 8))
        seq = rng.integers(0, 4, qlen)
        seq[rng.random(qlen) < 0.02] = 4
        reads.append(mk_read(p, cig, seq))
    return rng.integers(0, 4, 300), reads


def test_generate_data_equals_jax_on_test_cnn_gate_cases():
    # test_no_insertion_matches_simple's reads and window
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 200)
    reads = []
    for _ in range(40):
        p = int(rng.integers(40, 120))
        ln = int(rng.integers(20, 60))
        cigar = [(0, ln)]
        if rng.random() < 0.3:
            d = int(rng.integers(1, 5))
            cigar = [(0, ln // 2), (2, d), (0, ln - ln // 2)]
        if rng.random() < 0.3:
            cigar = [(4, int(rng.integers(1, 8)))] + cigar
        qlen = sum(l for op, l in cigar if op in (0, 4, 7, 8))
        reads.append(mk_read(p, cigar, rng.integers(0, 4, qlen)))
    # test_insertion_padding_shifts_and_gap_rows's read
    ins_ref = np.zeros(200, np.int64)
    ins_rd = mk_read(90, [(0, 10), (1, 2), (0, 10)],
                     [1] * 10 + [2, 2] + [3] * 10)
    for args in ((ref, reads, [], reads, 80, 110),
                 (ins_ref, [ins_rd], [], [ins_rd], 85, 115)):
        ours, ins = cf.generate_data(*args)
        theirs, jins = jcf.generate_data(*args)
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(ins, jins)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_features_equal_jax_on_seeded_reads(seed):
    ref, reads = seeded_reads(seed)
    tumor, normal = reads[:55], reads[55:]
    n_ins = 0
    for pos in (0, 7, 60, 75, 90, 100, 123, 139):
        ours = cf.features(ref, tumor, normal, pos)
        theirs = jcf.CnnFilter.features(None, ref, tumor, normal, pos)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert ours[0].dtype == np.float32
        n_ins += int(ours[1].sum() > 0)
    assert n_ins > 0                    # insertion padding took part


def test_gate_scan_skips_as_jax():
    """The positions classified, in order: the JAX gate_region's calls
    to features (with a classify that never keeps) against gate_inputs'
    positions, on seeded reads with insertions (which widen the skip
    window) and on test_cnn_gate.py's spacing case."""
    class Fake(jcf.CnnFilter):
        def __init__(self):
            self.calls = []

        def features(self, ref, t, n, pos):
            self.calls.append(pos)
            return jcf.CnnFilter.features(self, ref, t, n, pos)

        def classify(self, inputs):
            return False

    for seed in (0, 1, 2):
        ref, reads = seeded_reads(seed)
        events = [60, 62, 75, 75, 76, 90, 91, 104, 105, 106, 120, 139]
        fake = Fake()
        assert fake.gate_region(ref, reads[:55], reads[55:], events) is False
        inputs, at = cf.gate_inputs(ref, reads[:55], reads[55:], events)
        assert at == fake.calls
        assert inputs.shape == (len(at), 5, 6, 31)
        for row, pos in zip(inputs, at):
            np.testing.assert_array_equal(
                row, cf.features(ref, reads[:55], reads[55:], pos)[0])

    # test_cnn_gate.py's case: after 100 the window ends at 115
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 300)
    at = cf.gate_inputs(ref, [], [], [100, 103, 110, 116])[1]
    assert at == [100, 116]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return gate_model(tmp_path_factory.mktemp("gate") / "gate.pt", **MODEL)


@pytest.mark.parametrize("seed,scale", [(5, 200.0), (11, 400.0)])
def test_classify_equals_jax(tmp_path, seed, scale):
    """Row by row against the JAX package's CnnFilter, and the batched
    forward's decisions against the one-row forwards, on models that
    reach exactly 1.0 on part of the seeded rows."""
    model_path = gate_model(tmp_path / "gate.pt", seed, scale=scale)
    rows = []
    for k in range(4):
        ref, reads = seeded_reads(k)
        rows += [cf.features(ref, reads[:55], reads[55:], p)[0]
                 for p in range(60, 140, 4)]
    rows = np.stack(rows)
    ours = cf.CnnFilter(model_path, device="cpu")
    theirs = jcf.CnnFilter(model_path)
    one = [ours.classify(r) for r in rows]
    assert one == [theirs.classify(r) for r in rows]
    batched = cf.passes(ours.scores(rows))
    assert batched.tolist() == one
    assert 0 < sum(one) < len(one)
    scores = ours.scores(rows)
    assert (scores == 1.0).sum() == sum(one)
    assert ours.keep(rows) is True
    assert ours.keep(rows[~batched]) is False
    assert ours.keep(rows[:0]) is False
    # a region's decision: one batched forward against the JAX package's
    # scan with its early exit
    decisions = []
    for k in range(4):
        ref, reads = seeded_reads(k)
        for events in ([64, 66, 80], [90, 104, 120], [70, 71, 100, 130],
                       [61], [125, 139]):
            d = ours.gate_region(ref, reads[:55], reads[55:], events)
            assert d == theirs.gate_region(ref, reads[:55], reads[55:],
                                           events)
            decisions.append(d)
    assert 0 < sum(decisions) < len(decisions)


def test_mutect_deep_model_cli_equals_jax(tmp_path, model_path):
    files = [CNN_FIX / "ref.fa", CNN_FIX / "tumor.bam",
             CNN_FIX / "normal.bam"]
    out = run_both_clis(tmp_path, files, ["--deep-model", model_path],
                        tags=("", " -t 2"))
    assert same_vcf(out["jax"], out["torch"])
    assert same_vcf(out["torch"], out["torch -t 2"])
    sites = lambda p: {tuple(ln.split("\t")[:2]) for ln in
                       pathlib.Path(p).read_text().splitlines()
                       if ln and not ln.startswith("#")}
    gated = sites(out["torch"])
    ungated = sites(CNN_FIX / "golden_nogate.vcf")
    # the model keeps some regions and drops others
    assert gated and gated < ungated
