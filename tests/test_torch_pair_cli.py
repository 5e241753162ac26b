"""The port's `mem` and `pipeline` with two FASTQs on the CPU against
fgdp_tpu's CLI: the same SAM in-process and with a 2-worker finalize
pool, the same BAM and BAI bytes through `pipeline -t 2`, on the golden
pairs with five second ends baited (every 12th base changed, so only
mate rescue places them: tests/test_torch_pair.py); and the paired
FASTQ reader equal to fgdp_tpu's."""

import os

import numpy as np
import pytest

from fgdp_tpu import cli as jcli
from fgdp_tpu_torch import cli
from fgdp_tpu_torch.pipeline_stream import POOL_KSWV

from test_torch_pair import BAIT_PAIRS
from test_torch_seeding import one_torch_thread  # noqa: F401

HERE = os.path.join(os.path.dirname(__file__), "golden")
REF = os.path.join(HERE, "ref.fa")


@pytest.fixture(scope="module")
def baited_fastqs(tmp_path_factory):
    """pe1.fq and pe2.fq with BAIT_PAIRS' second ends baited."""
    tmp = tmp_path_factory.mktemp("pe")
    with open(os.path.join(HERE, "pe2.fq")) as f:
        lines = f.read().splitlines()
    nxt = str.maketrans("ACGT", "CGTA")
    for i in BAIT_PAIRS:
        s = list(lines[4 * i + 1])
        s[::12] = [c.translate(nxt) for c in s[::12]]
        lines[4 * i + 1] = "".join(s)
    (tmp / "r2.fq").write_text("\n".join(lines) + "\n")
    return os.path.join(HERE, "pe1.fq"), str(tmp / "r2.fq")


def test_read_batches_keep_pairs_whole(baited_fastqs):
    """Batches of an odd read count take batch // 2 pairs, interleaved,
    as fgdp_tpu's CLI reader does."""
    got = list(cli.read_batches(list(baited_fastqs), 9))
    want = list(jcli._read_batches(list(baited_fastqs), 9))
    assert len(got) == len(want) == 25
    for a, b in zip(got, want):
        assert a[0] == b[0] and a[2] == b[2] and len(a[0]) == 8
        assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))


def test_cli_paired_runs_equal_jax(baited_fastqs, tmp_path):
    """`mem` with two FASTQs writes fgdp_tpu's SAM in-process and with
    -t 2 (the workers rescue on the CPU, as --device cpu asks), and
    `pipeline -t 2` fgdp_tpu's BAM and BAI bytes; two batches of 50
    pairs."""
    jcli.main(["index", REF, str(tmp_path / "jidx")])
    common = ["-b", "100"]
    jcli.main(["mem", str(tmp_path / "jidx"), *baited_fastqs, "-o",
               str(tmp_path / "j.sam"), *common])
    jcli.main(["pipeline", str(tmp_path / "jidx"), *baited_fastqs, "-O",
               str(tmp_path / "j.bam"), *common])
    cli.main(["index", REF, str(tmp_path / "idx")])
    want = (tmp_path / "j.sam").read_text()
    p0 = dict(POOL_KSWV)
    for t in ("0", "2"):
        out = tmp_path / f"m{t}.sam"
        cli.main(["mem", str(tmp_path / "idx"), *baited_fastqs, "-o",
                  str(out), "--device", "cpu", "-t", t, *common])
        assert out.read_text() == want
    assert POOL_KSWV["jobs"] > p0["jobs"] and POOL_KSWV["launches"] == 0
    n, nrec, _ = cli.main(["pipeline", str(tmp_path / "idx"),
                           *baited_fastqs, "-O", str(tmp_path / "p.bam"),
                           "--device", "cpu", "-t", "2", *common])
    assert n == 200 and nrec >= 200
    assert (tmp_path / "p.bam").read_bytes() == \
        (tmp_path / "j.bam").read_bytes()
    assert (tmp_path / "p.bam.bai").read_bytes() == \
        (tmp_path / "j.bam.bai").read_bytes()
    records = [ln for ln in want.splitlines() if not ln.startswith("@")]
    assert len(records) >= 200
