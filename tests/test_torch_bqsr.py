"""The port's BQSR (call/bqsr.py) against the JAX package's: the GATK
report parsing, the covariate keys and the recalibrated quals (exact
integers) on seeded reads (both strands, second of pair, N bases,
low-quality tails), and `mutect --bqsr-tumor/--bqsr-normal` through both
CLIs on tests/golden/mutect, streamed (BAI windows) and whole-BAM."""

import os
import pathlib
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

from fgdp_tpu.call import bqsr as jbqsr
from fgdp_tpu_torch.call import bqsr
from fgdp_tpu_torch.io import bgzf

from test_bqsr import REPORT
from test_torch_cuda import recal_report
from test_torch_seeding import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
FIX = ROOT / "tests" / "golden" / "mutect"
# the JAX package's float32 PairHMM and the port's differ in the last
# digits of a LOD or an AF (tests/test_torch_call.py's LOD_TOL is 0.01)
NUM_TOL = 1e-4


def seeded_reads(seed, n=60):
    """Read dicts as cli._bam_to_read_dicts makes them, plus the pairing
    keys BQSR's cycle covariate reads."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(20, 160))
        codes = rng.integers(0, 4, L)
        codes[rng.random(L) < 0.03] = 4                   # N bases
        quals = rng.choice([2, 5, 6, 20, 30, 37], L,
                           p=[.05, .05, .05, .15, .3, .4])
        if i % 3 == 0:                                    # low-qual tails
            quals[:int(rng.integers(1, 5))] = 2
            quals[-int(rng.integers(1, 5)):] = 2
        out.append(dict(seq_codes=codes.astype(np.int64),
                        quals=quals.astype(np.int64),
                        is_reverse=bool(i % 2),
                        second_of_pair=bool(i % 4 >= 2),
                        paired=bool(i % 5), properly_paired=False))
    return out


def test_parse_gatk_report_equals_jax():
    for text in (REPORT, recal_report(REPORT, "tumor")):
        assert bqsr.parse_gatk_report(text) == \
            jbqsr.parse_gatk_report(text)
    assert len(bqsr.parse_gatk_report(recal_report(REPORT, "tumor"))
               ["RecalTable2"]) == 9


def test_covariate_keys_equal_jax():
    for r in seeded_reads(3):
        codes, quals = r["seq_codes"], r["quals"]
        for ctx in (2, 3):
            np.testing.assert_array_equal(
                bqsr.context_keys(codes, quals, r["is_reverse"], ctx),
                jbqsr.context_keys(codes, quals, r["is_reverse"], ctx))
        for rev in (False, True):
            for second in (False, True):
                for paired in (False, True):
                    np.testing.assert_array_equal(
                        bqsr.cycle_keys(len(codes), rev, second, paired),
                        jbqsr.cycle_keys(len(codes), rev, second, paired))
    for c in (-500, -3, -1, 1, 2, 151, 500):
        assert bqsr.key_from_cycle(c) == jbqsr.key_from_cycle(c)
    with pytest.raises(ValueError):
        bqsr.key_from_cycle(501)
    for n_obs, n_err, q in ((0, 0, 30.0), (10, 0, 40.0),
                            (1_000_000, 1000, 40.0), (2**33, 2**20, 20.0)):
        assert bqsr.bayesian_empirical_quality(n_obs, n_err, q) == \
            jbqsr.bayesian_empirical_quality(n_obs, n_err, q)


@pytest.mark.parametrize("text", ["plain", "fixture"])
def test_apply_equals_jax(text):
    rep = REPORT if text == "plain" else recal_report(REPORT, "tumor")
    ours = bqsr.BQSRReadTransformer(rep)
    theirs = jbqsr.BQSRReadTransformer(rep)
    reads = seeded_reads(5)
    changed = 0
    for r in reads:
        a, b = dict(r), dict(r)
        ours.apply(a)
        theirs.apply(b)
        assert a["quals"].dtype == b["quals"].dtype == np.int64
        np.testing.assert_array_equal(a["quals"], b["quals"])
        changed += int((a["quals"] != r["quals"]).sum())
    assert changed > 0


def _numbers_close(a: str, b: str) -> bool:
    """Same text with every number within NUM_TOL (relative above 1)."""
    num = r"-?\d+(?:\.\d+)?(?:e-?\d+)?"
    if re.sub(num, "#", a) != re.sub(num, "#", b):
        return False
    return all(abs(float(x) - float(y)) <= NUM_TOL * max(1.0, abs(float(x)))
               for x, y in zip(re.findall(num, a), re.findall(num, b)))


def same_vcf(path_a, path_b):
    """Equal records (header lines aside), numbers within NUM_TOL."""
    rec = lambda p: [ln for ln in pathlib.Path(p).read_text().splitlines()
                     if not ln.startswith("##")]
    a, b = rec(path_a), rec(path_b)
    return len(a) == len(b) and all(_numbers_close(x, y)
                                    for x, y in zip(a, b))


def run_both_clis(tmp_path, fix_files, extra, tags=("",)):
    """`mutect` on `fix_files` (ref.fa, tumor.bam, normal.bam) through
    `python -m fgdp_tpu` and `python -m fgdp_tpu_torch --device cpu`
    with `extra` flags, once per tag (appended to the port's flags), all
    processes at once. Returns {name: VCF path}."""
    ref, tumor, normal = fix_files
    base = ["mutect", "-R", str(ref), "-I", str(tumor), "-N", str(normal)]
    env = dict(os.environ, **ONE_THREAD_ENV)
    runs = {"jax": [sys.executable, "-m", "fgdp_tpu"] + base + extra}
    for t in tags:
        runs["torch" + t] = [sys.executable, "-m", "fgdp_tpu_torch"] + \
            base + extra + ["--device", "cpu"] + t.split()
    out = {}
    procs = []
    for name, cmd in runs.items():
        out[name] = tmp_path / f"{name.replace(' ', '_')}.vcf"
        procs.append(subprocess.Popen(cmd + ["-O", str(out[name])],
                                      cwd=str(ROOT), env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    return out


def window_bam(src, dst, rid, lo, hi):
    """Copy of BAM `src` holding only the records of contig `rid` that
    start in [lo, hi), without a BAI (so `mutect` reads it whole)."""
    data = bgzf.decompress(pathlib.Path(src).read_bytes())
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    out = [data[:off]]
    while off + 4 <= len(data):
        sz = struct.unpack_from("<I", data, off)[0]
        r, pos = struct.unpack_from("<ii", data, off + 4)
        if r == rid and lo <= pos < hi:
            out.append(data[off:off + 4 + sz])
        off += 4 + sz
    blocks, _ = bgzf.compress_stream(b"".join(out), threads=1)
    pathlib.Path(dst).write_bytes(blocks + bgzf.EOF_BLOCK)
    return dst


@pytest.mark.parametrize("streamed", [True, False])
def test_mutect_bqsr_cli_equals_jax(tmp_path, streamed):
    """Both samples recalibrated by a report naming their read group.
    Streamed: the fixture's BAMs with their BAIs (per window); whole-BAM:
    chr1's reads starting in [20000, 27000) without a BAI (every read
    before calling)."""
    files = [FIX / "ref.fa", FIX / "tumor.bam", FIX / "normal.bam"]
    if not streamed:
        for i in (1, 2):
            files[i] = window_bam(files[i], tmp_path / files[i].name, 0,
                                  20_000, 27_000)
    for rg in ("tumor", "normal"):
        (tmp_path / f"{rg}.recal").write_text(recal_report(REPORT, rg))
    out = run_both_clis(tmp_path, files,
                        ["--bqsr-tumor", str(tmp_path / "tumor.recal"),
                         "--bqsr-normal", str(tmp_path / "normal.recal")])
    assert same_vcf(out["jax"], out["torch"])
    calls = [ln for ln in out["torch"].read_text().splitlines()
             if not ln.startswith("#")]
    assert calls
    # recalibrated: no base keeps the fixture's quality 37
    assert all("MBQ=37" not in ln for ln in calls)
