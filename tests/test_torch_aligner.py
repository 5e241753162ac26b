"""The port's `index` + `mem --device cpu` against fgdp_tpu's Aligner.

SAM lines must be identical to fgdp_tpu's on the same batch, and pass
test_golden's field compare against the reference aligner's output. A
small-BatchShapes case drives the overflow ladder through all its rungs
and must match too, and so must non-default options: test_golden's
option flags (-k 25 -T 40 -B 5 -L 3) through the Aligner, `-a` and `-R`
through the two CLIs."""

import os
import subprocess
import sys

import pytest

from fgdp_tpu import cli as jcli
from fgdp_tpu.config import AlignConfig as JAlignConfig
from fgdp_tpu.config import BatchShapes as JBatchShapes
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.pipeline import Aligner as JAligner
from fgdp_tpu_torch.config import AlignConfig, BatchShapes
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.pipeline import Aligner

from test_golden import CORE, _compare, _load_fastq
from test_torch_seeding import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

HERE = os.path.join(os.path.dirname(__file__), "golden")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 128

FIXTURES = {
    "se": ("ref.fa", "se.fq", "se.oracle.sam", 150, 150),
    "rep": ("rep_ref.fa", "rep.fq", "rep.oracle.sam", 80, 79),
    "alt": ("alt_ref.fa", "alt.fq", "alt.oracle.sam", 48, 48),
}


def _records(lines):
    return [ln for ln in lines if ln and not ln.startswith("@")]


def _run_cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD_ENV)
    return subprocess.run([sys.executable, "-m", "fgdp_tpu_torch", *args],
                          cwd=cwd, env=env, check=True,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("fx", sorted(FIXTURES))
def test_cli_mem_matches_jax(fx, tmp_path):
    ref, fq, oracle, min_core, min_full = FIXTURES[fx]
    prefix = str(tmp_path / "idx")
    _run_cli("index", os.path.join(HERE, ref), prefix, cwd=tmp_path)
    out = tmp_path / "out.sam"
    _run_cli("mem", prefix, os.path.join(HERE, fq), "-o", str(out),
             "-b", str(BATCH), "--device", "cpu", cwd=tmp_path)
    ours = out.read_text().splitlines()

    names, seqs, quals = _load_fastq(os.path.join(HERE, fq))
    jal = JAligner.build(JPackedReference.from_fasta(os.path.join(HERE,
                                                                  ref)),
                         shapes=JBatchShapes(batch_reads=BATCH))
    want = jal.sam_header() + jal.align_batch(names, seqs, quals)
    assert ours == want
    with open(os.path.join(HERE, oracle)) as f:
        _compare(f.read().splitlines(), ours, CORE, min_core, min_full,
                 len(names))


# tight caps: most reads overflow some stage, so the ladder's rungs
# (k2w and cw at level 1, full and cw at level 2) all run
LADDER = dict(read_len=100, batch_reads=64, max_smems=1, max_seeds=8,
              max_chains=2, max_regs=3, transfer_regs=2, pack_cap=1,
              max_ext_ref=304)


def test_overflow_ladder_matches_jax(monkeypatch):
    names, seqs, quals = _load_fastq(os.path.join(HERE, "rep.fq"))
    names, seqs, quals = names[:64], seqs[:64], quals[:64]
    al = Aligner.build(PackedReference.from_fasta(
        os.path.join(HERE, "rep_ref.fa")), shapes=BatchShapes(**LADDER),
        device="cpu")
    rungs = []
    esc = al._esc_exec

    def spy(flavor, level, *a):
        rungs.append((flavor, level))
        return esc(flavor, level, *a)

    monkeypatch.setattr(al, "_esc_exec", spy)
    ours = al.align_batch(names, seqs, quals)
    assert {("k2w", 1), ("cw", 1), ("full", 2), ("cw", 2)} <= set(rungs), \
        rungs
    jal = JAligner.build(JPackedReference.from_fasta(
        os.path.join(HERE, "rep_ref.fa")), shapes=JBatchShapes(**LADDER))
    want = jal.align_batch(names, seqs, quals)
    assert ours == want
    assert al.esc_reads == jal.esc_reads


# test_golden.test_golden_option_flags' options (-k 25 -T 40 -B 5 -L 3)
# and test_golden's shapes (SHAPES)
OPT_FLAGS = dict(min_seed_len=25, T=40, b=5, pen_clip5=3, pen_clip3=3)
GOLDEN_SHAPES = dict(read_len=100, batch_reads=128, max_smems=128,
                     max_seeds=192, max_chains=24, max_regs=24,
                     max_ext_ref=304)


def test_option_flags_match_jax():
    """The port's Aligner with test_golden's non-default options on the
    alt fixture writes fgdp_tpu's SAM lines, field-compared to the
    reference binary's run with the same flags as test_golden does."""
    fa = os.path.join(HERE, "alt_ref.fa")
    names, seqs, quals = _load_fastq(os.path.join(HERE, "alt.fq"))
    al = Aligner.build(PackedReference.from_fasta(fa),
                       opt=AlignConfig(**OPT_FLAGS),
                       shapes=BatchShapes(**GOLDEN_SHAPES), device="cpu")
    ours = al.align_batch(names, seqs, quals)
    jal = JAligner.build(JPackedReference.from_fasta(fa),
                         opt=JAlignConfig(**OPT_FLAGS),
                         shapes=JBatchShapes(**GOLDEN_SHAPES))
    assert ours == jal.align_batch(names, seqs, quals)
    with open(os.path.join(HERE, "opt.oracle.sam")) as f:
        _compare(f.read().splitlines(), ours, CORE, 48, 47, len(names))


@pytest.mark.parametrize("flags", [["-a"], ["-R", r"@RG\tID:x\tSM:y"]])
def test_cli_mem_options_match_jax(flags, tmp_path):
    """`mem -a` (every alignment) and `mem -R` (a read group line)
    through the port's CLI write what fgdp_tpu's CLI writes."""
    ref, fq = (os.path.join(HERE, f) for f in FIXTURES["se"][:2])
    _run_cli("index", ref, str(tmp_path / "idx"), cwd=tmp_path)
    _run_cli("mem", str(tmp_path / "idx"), fq, "-o", str(tmp_path / "t.sam"),
             "-b", str(BATCH), "--device", "cpu", *flags, cwd=tmp_path)
    jcli.main(["index", ref, str(tmp_path / "jidx")])
    jcli.main(["mem", str(tmp_path / "jidx"), fq, "-o",
               str(tmp_path / "j.sam"), "-b", str(BATCH), *flags])
    ours = (tmp_path / "t.sam").read_text()
    assert ours == (tmp_path / "j.sam").read_text()
    assert len(_records(ours.splitlines())) >= 150
    if flags[0] == "-R":
        # both packages write the header line as given
        assert flags[1] in ours.splitlines()
