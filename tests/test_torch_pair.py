"""The port's paired-end alignment on the CPU against fgdp_tpu's.

Insert-size statistics and batched mate rescue must leave fgdp_tpu's reg
lists (and the per-pair scalar rescue's) on pairs whose baited ends
seeding cannot place; `Aligner.align_pairs` must write fgdp_tpu's SAM
lines on the golden pairs, field-equal to the reference aligner's run,
and on the golden pairs with baited ends (test_torch_pair_cli.py holds
`mem` and `pipeline` with two FASTQs). A baited end has every 12th base
changed: its
longest exact run (11) is below the minimum seed length (19), so only
mate rescue can place it (tests/test_pe_align.py)."""

import copy
import dataclasses
import os

import numpy as np
import pytest

from fgdp_tpu.align import pair as jpair
from fgdp_tpu.index.reference import PackedReference as JPackedReference
from fgdp_tpu.pipeline import Aligner as JAligner
from fgdp_tpu_torch.align import pair
from fgdp_tpu_torch.config import BatchShapes
from fgdp_tpu_torch.index.reference import PackedReference
from fgdp_tpu_torch.ops import kswv
from fgdp_tpu_torch.pipeline import Aligner, _reg_lists_np

from test_golden import PAIR_COLS, _compare, _load_fastq
from test_golden import SHAPES as GOLDEN_SHAPES
from test_pe_align import SHAPES as PE_SHAPES
from test_pe_align import _simulate_pairs
from test_torch_seeding import one_torch_thread  # noqa: F401

HERE = os.path.join(os.path.dirname(__file__), "golden")
REF = os.path.join(HERE, "ref.fa")
# golden pairs whose second end (odd rows) is baited
BAIT_PAIRS = (3, 17, 41, 75, 95)


def _bait(s):
    s = np.array(s)
    s[::12] = (s[::12] + 1) % 4
    return s


def _golden_pairs(baited=False):
    n1, s1, q1 = _load_fastq(os.path.join(HERE, "pe1.fq"))
    n2, s2, q2 = _load_fastq(os.path.join(HERE, "pe2.fq"))
    if baited:
        s2 = [_bait(s) if i in BAIT_PAIRS else s for i, s in enumerate(s2)]
    inter = lambda a, b: [x for p in zip(a, b) for x in p]
    return inter(n1, n2), inter(s1, s2), inter(q1, q2)


def _shapes(mod, shapes):
    return mod(**{f.name: getattr(shapes, f.name)
                  for f in dataclasses.fields(shapes)})


def test_pestat_and_rescue_equal_jax():
    """test_pe_align's rescue case: 24 simulated pairs, three ends
    baited; the port's pestat and rescue_all leave fgdp_tpu's reg lists,
    which equal the per-pair scalar rescue's, and rescues fire."""
    rng = np.random.default_rng(17)
    pref = PackedReference.from_contigs(
        ["chr1"], [rng.integers(0, 4, 6000).astype(np.uint8)])
    al = Aligner.build(pref, shapes=_shapes(BatchShapes, PE_SHAPES),
                       device="cpu")
    names, reads, _ = _simulate_pairs(np.random.default_rng(11), pref, 24)
    for k in (1, 4, 9):
        reads[k] = _bait(reads[k])
    reg_lists = _reg_lists_np(pref, al.opt, reads, al._device_regs(reads))
    pairs = [(reg_lists[2 * i], reg_lists[2 * i + 1])
             for i in range(len(reads) // 2)]
    codes = [(reads[2 * i], reads[2 * i + 1]) for i in range(len(pairs))]
    jpref = JPackedReference.from_contigs(["chr1"], [pref.codes])
    pes = pair.pestat(al.opt, pref.l_pac, pairs)
    assert [dataclasses.asdict(p) for p in pes] == \
        [dataclasses.asdict(p) for p in jpair.pestat(al.opt, pref.l_pac,
                                                     pairs)]
    assert not pes[1].failed

    ours, theirs, seq = (copy.deepcopy(pairs) for _ in range(3))
    w0 = dict(kswv.WORK)
    pair.rescue_all(al.opt, pref, pes, ours, codes, device="cpu")
    jpair.rescue_all(al.opt, jpref, jpair.pestat(al.opt, pref.l_pac, pairs),
                     theirs, codes)
    n_seq = 0
    for p, regs_pair in enumerate(seq):
        for i in (0, 1):
            if not regs_pair[i]:
                continue
            best = regs_pair[i][0]["score"]
            cand = [r for r in regs_pair[i]
                    if r["score"] >= best - al.opt.pen_unpaired]
            for anchor in cand[:al.opt.max_matesw]:
                n_seq += pair.matesw(al.opt, pref, pes, anchor,
                                     codes[p][1 - i], regs_pair[1 - i])
    assert n_seq >= 3 and kswv.WORK["jobs"] > w0["jobs"]
    assert ours == theirs == seq


@pytest.mark.parametrize("baited", [False, True], ids=["golden", "baited"])
def test_align_pairs_equals_jax(baited):
    """The golden pairs (field-compared with the reference aligner's SAM
    as test_golden does) and the same pairs with baited ends, which only
    the kswv batches place."""
    names, seqs, quals = _golden_pairs(baited)
    al = Aligner.build(PackedReference.from_fasta(REF),
                       shapes=_shapes(BatchShapes, GOLDEN_SHAPES),
                       device="cpu")
    w0 = dict(kswv.WORK)
    ours = al.align_pairs(names, seqs, quals)
    jal = JAligner.build(JPackedReference.from_fasta(REF),
                         shapes=GOLDEN_SHAPES)
    assert ours == jal.align_pairs(names, seqs, quals)
    if baited:
        assert kswv.WORK["jobs"] - w0["jobs"] >= len(BAIT_PAIRS)
        placed = {f[0] for f in (ln.split("\t") for ln in ours)
                  if int(f[1]) & 0x82 == 0x82}
        assert {names[2 * i] for i in BAIT_PAIRS} <= placed
    else:
        with open(os.path.join(HERE, "pe.oracle.sam")) as f:
            _compare(f.read().splitlines(), ours, PAIR_COLS, 200, 200,
                     len(names))
