"""The port's FASTQ -> sorted, duplicate-marked BAM stream on the CPU
against fgdp_tpu's.

`stream_fastq_to_bam` with a 2-worker FinalizePool must write the BAM
and BAI bytes of fgdp_tpu's in-process `stream_fastq_to_bam` on the same
reads, batch and caps. The reads are the first 48 of the golden
single-end fixture plus renamed copies of every sixth (duplicates to
mark, with reversed qualities). Four transfer slots per read make one of
them (read 34 and its copy) overflow: it is pulled out of its batch and
comes back through the deferred escalation with its original id."""

import os

import numpy as np
import pytest

from fgdp_tpu.cli import _read_batches as jread_batches
from fgdp_tpu.config import BatchShapes as JBatchShapes
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.pipeline import Aligner as JAligner
from fgdp_tpu.pipeline_stream import stream_fastq_to_bam as jstream
from fgdp_tpu_torch import cli
from fgdp_tpu_torch.config import BatchShapes
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.io import bam
from fgdp_tpu_torch.pipeline import Aligner, finalize_se_batch
from fgdp_tpu_torch.pipeline_stream import (FinalizePool,
                                            stream_fastq_to_bam)

from test_torch_seeding import one_torch_thread  # noqa: F401

HERE = os.path.join(os.path.dirname(__file__), "golden")
REF = os.path.join(HERE, "ref.fa")
BATCH = 32
TIGHT = dict(batch_reads=BATCH, transfer_regs=4)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    with open(os.path.join(HERE, "se.fq")) as f:
        lines = f.read().splitlines()
    recs = [lines[i:i + 4] for i in range(0, 4 * 48, 4)]
    recs += [[f"@dup{j}", recs[j][1], "+", recs[j][3][::-1]]
             for j in range(0, 48, 6)]
    path = tmp_path_factory.mktemp("reads") / "reads.fq"
    path.write_text("\n".join(sum(recs, [])) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def jax_bam(fastq, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    al = JAligner.build(JPackedReference.from_fasta(REF),
                        shapes=JBatchShapes(**TIGHT))
    out = tmp / "jax.bam"
    n, res = jstream(al, jread_batches([fastq], BATCH), str(out),
                     paired=False)
    assert al.esc_reads > 0, "the caps must make reads escalate"
    return n, res, out.read_bytes(), (tmp / "jax.bam.bai").read_bytes()


def test_pooled_stream_equals_jax(fastq, jax_bam, tmp_path):
    pref = PackedReference.from_fasta(REF)
    pref.save(str(tmp_path / "idx.ref"))
    al = Aligner.build(pref, shapes=BatchShapes(**TIGHT), device="cpu")
    out = tmp_path / "port.bam"
    pool = FinalizePool(str(tmp_path / "idx.ref"), al.opt, 2)
    try:
        n, res = stream_fastq_to_bam(al, cli.read_batches([fastq], BATCH),
                                     str(out), pool=pool)
    finally:
        pool.shutdown()
    assert al.esc_reads > 0 and al.esc_calls > 0   # deferred reads ran
    assert (n, res) == jax_bam[:2]
    assert out.read_bytes() == jax_bam[2]
    assert (tmp_path / "port.bam.bai").read_bytes() == jax_bam[3]
    _, _, _, recs = bam.read_bam(out)
    assert n == 56 and len(recs) == res[0] and res[1] >= 8


def test_finalize_takes_per_read_ids(fastq):
    """A per-read id array gives the lines that a scalar base gives when
    the ids are the same (ids feed the hash_64 tie-breaks)."""
    pref = PackedReference.from_fasta(REF)
    al = Aligner.build(pref, shapes=BatchShapes(batch_reads=BATCH),
                       device="cpu")
    names, seqs, quals = next(cli.read_batches([fastq], BATCH))
    regs = al._device_regs(seqs)
    base = finalize_se_batch(pref, al.opt, None, names, seqs, quals, regs,
                             40)
    ids = finalize_se_batch(pref, al.opt, None, names, seqs, quals, regs,
                            40 + np.arange(len(names)))
    assert base == ids


def test_cli_pooled_runs_equal_in_process(fastq, tmp_path):
    """`mem -t 2` writes the SAM of `mem`, and `pipeline -t 2` the BAM
    and BAI of `pipeline` (both on the CPU, the workers spawned)."""
    prefix = str(tmp_path / "idx")
    cli.main(["index", REF, prefix])
    out = {}
    for t in ("0", "2"):
        sam, bam_path = tmp_path / f"m{t}.sam", tmp_path / f"p{t}.bam"
        common = [prefix, fastq, "--device", "cpu", "-b", "24", "-t", t]
        cli.main(["mem", *common, "-o", str(sam)])
        cli.main(["pipeline", *common, "-O", str(bam_path)])
        out[t] = (sam.read_text(), bam_path.read_bytes(),
                  (tmp_path / f"p{t}.bam.bai").read_bytes())
    assert out["0"] == out["2"]
    assert out["0"][0].count("\n") > 56
