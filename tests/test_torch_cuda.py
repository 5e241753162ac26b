"""The CUDA kernels and the aligner on the card (marked `cuda`: these skip
where there is no card). Each kernel must equal its plain PyTorch version
on the same CUDA inputs exactly, and the aligner on the card must write
the same SAM lines as on the CPU.

This file imports neither jax nor fgdp_tpu, so it runs on a machine
that has only the port's dependencies; tests/conftest.py sets up JAX, so
run it there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It also holds the seeded inputs that test_torch_sw.py and
test_torch_chain.py share with it."""

import os

import numpy as np
import pytest
import torch

from fgdp_tpu_torch.align import chain
from fgdp_tpu_torch.config import AlignConfig, BatchShapes
from fgdp_tpu_torch.ops import kernels, sw

HERE = os.path.join(os.path.dirname(__file__), "golden")
OPT = AlignConfig()


def sw_pairs(seed, n, qmax, tmax, mut=0.05, n_frac=0.0):
    """Extension-shaped pairs: target an error-laden copy of the query
    most of the time; some empty lanes; optional N bases."""
    rng = np.random.default_rng(seed)
    qs = np.zeros((n, qmax), np.int32)
    ts = np.zeros((n, tmax), np.int32)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    for i in range(n):
        ql = int(rng.integers(1, qmax + 1))
        tl = int(rng.integers(1, tmax + 1))
        q = rng.integers(0, 4, ql)
        t = rng.integers(0, 4, tl)
        if rng.random() < 0.7:
            tl = min(tmax, ql + int(rng.integers(0, 20)))
            t = np.concatenate([q, rng.integers(0, 4, max(0, tl - ql))])[:tl]
            m = rng.random(tl) < mut
            t = np.where(m, rng.integers(0, 4, tl), t)
        if n_frac:
            q = np.where(rng.random(ql) < n_frac, 4, q)
            t = np.where(rng.random(tl) < n_frac, 4, t)
        qs[i, :ql] = q
        ts[i, :tl] = t
        qlen[i] = ql
        tlen[i] = tl
    qlen[::9] = 0                        # empty lanes: the skip path
    tlen[4::11] = 0
    h0 = rng.integers(1, 80, n).astype(np.int32)
    return qs, qlen, ts, tlen, h0


# the cases of tests/test_sw.py: parity, narrow bands, N bases, z-drop
SW_CASES = {
    "parity": dict(args=(1, 64, 96, 128), w=100, bonus=OPT.pen_clip5),
    "narrow3": dict(args=(2, 48, 64, 80, 0.15), w=3, bonus=OPT.pen_clip3),
    "narrow10": dict(args=(3, 48, 64, 80, 0.15), w=10, bonus=OPT.pen_clip3),
    "n_bases": dict(args=(4, 48, 64, 96, 0.05, 0.05), w=100,
                    bonus=OPT.pen_clip5),
    "zdrop": dict(args=(5, 48, 90, 120, 0.35), w=100, bonus=OPT.pen_clip5),
}


def sw_params(mod, end_bonus):
    """`mod.SWParams` (the port's or the JAX package's) at the default
    scoring."""
    return mod.SWParams(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
                        e_ins=OPT.e_ins, zdrop=OPT.zdrop,
                        end_bonus=end_bonus, mat_max=OPT.a)


def synth_seeds(seed, B, P, l_pac):
    """Random seed columns shaped like expand_seeds output: qbeg
    ascending, diagonal runs with jumps, repeats that get contained,
    both strands, two contigs, invalid slots."""
    rng = np.random.default_rng(seed)
    qbeg = np.sort(rng.integers(0, 130, (B, P)), axis=1).astype(np.int32)
    diag = rng.integers(0, 2 * l_pac - 300, (B, 1))
    jump = rng.integers(0, 2 * l_pac - 300, (B, P))
    rbeg = np.where(rng.random((B, P)) < 0.7, diag + qbeg, jump)
    rbeg = (rbeg + rng.integers(-3, 4, (B, P))).clip(0).astype(np.int32)
    slen = rng.integers(19, 45, (B, P)).astype(np.int32)
    dup = rng.random((B, P)) < 0.2
    qbeg[:, 1:] = np.where(dup[:, 1:], qbeg[:, :-1], qbeg[:, 1:])
    rbeg[:, 1:] = np.where(dup[:, 1:], rbeg[:, :-1], rbeg[:, 1:])
    rid = (rbeg >= l_pac).astype(np.int32)
    valid = rng.random((B, P)) < 0.8
    valid[rng.random(B) < 0.1] = False          # reads with no seeds
    ovf = rng.random(B) < 0.1
    return qbeg, rbeg, slen, rid, valid, ovf


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SW_CASES))
def test_sw_kernel_equals_plain(dev, case):
    c = SW_CASES[case]
    args = [torch.as_tensor(a, device=dev) for a in sw_pairs(*c["args"])]
    p = sw_params(sw, c["bonus"])
    n0 = kernels.LAUNCHES["sw_extend"]
    got = sw.sw_extend(*args, c["w"], p)
    assert kernels.LAUNCHES["sw_extend"] == n0 + 1
    want = sw.sw_extend_plain(*args, c["w"], p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sw_kernel_refuses_qlen_above_query_width(dev):
    args = [torch.as_tensor(a, device=dev) for a in sw_pairs(6, 8, 16, 32)]
    args[1][3] = 17                      # qlen above QP = 16
    n0 = kernels.LAUNCHES["sw_extend"]
    with pytest.raises(ValueError, match="query width"):
        sw.sw_extend_kernel(*args, 100, sw_params(sw, OPT.pen_clip5))
    assert kernels.LAUNCHES["sw_extend"] == n0


# the largest escalated shape (P = 2048, C = 256) included
@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,P,C", [(7, 20, 48, 8), (8, 300, 512, 3),
                                        (9, 64, 2048, 256)])
def test_chain_kernel_equals_plain(dev, seed, B, P, C):
    cols = [torch.as_tensor(a, device=dev)
            for a in synth_seeds(seed, B, P, 5000)]
    got = chain.chain_loop(*cols, 5000, C, OPT.w, OPT.max_chain_gap)
    want = chain.chain_loop_plain(*cols, 5000, C, OPT.w, OPT.max_chain_gap)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_aligner_on_card_equals_cpu(dev):
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.pipeline import Aligner
    from fgdp_tpu_torch.utils import dna

    pref = PackedReference.from_fasta(os.path.join(HERE, "rep_ref.fa"))
    fm = FMIndex.build(pref.codes)
    recs = list(parse_fastq_records(os.path.join(HERE, "rep.fq")))
    names = [r[0] for r in recs]
    seqs = [dna.encode(r[2]).astype(np.int64) for r in recs]
    quals = [r[3].decode() for r in recs]
    shapes = BatchShapes(batch_reads=128)
    on_card = Aligner(pref, fm, shapes=shapes, device=dev)
    on_cpu = Aligner(pref, fm, shapes=shapes, device="cpu")
    assert on_card.align_batch(names, seqs, quals) == \
        on_cpu.align_batch(names, seqs, quals)
