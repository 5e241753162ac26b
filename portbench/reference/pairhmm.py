"""Plain PairHMM forward likelihoods in float64, NumPy only: the GKL /
GATK semantics (Context.h, pairhmm_common.h) as the port's caller
states them, computed cell by cell.

Inputs per pair: the read's bases (0-3, 4 for N), its base, insertion,
deletion and gap-continuation qualities, the haplotype's bases. The
transition probabilities come from the qualities here (the Jacobian
table's matchToMatch, ph2pr), not from the program. Recurrences, with
prior = 1 - e or e / 3 (e = 10^(-q/10); a base N on either side
matches):
  M[i][j] = prior * (tMM M[i-1][j-1] + tGM (X[i-1][j-1] + Y[i-1][j-1]))
  X[i][j] = tMX M[i-1][j] + tXX X[i-1][j]
  Y[i][j] = tMY M[i][j-1] + tYY Y[i][j-1]
with Y[0][j] = 2^1020 / hlen in the first row and the result
log10(sum_j M[R][j] + X[R][j]) - log10(2^1020). Eleven floating-point
operations a cell, an FMA counted as two (M 5, X 3, Y 3).

`forward(..., bf16=True)` rounds every input and every intermediate to
bfloat16: the control's lower precision.
"""

from __future__ import annotations

import functools

import numpy as np

FLOPS_PER_CELL = 11
LOG10_SCALE = 1020 * np.log10(2.0)
MAX_QUAL = 254


@functools.lru_cache()
def match_to_match():
    """matchToMatch[(max*(max+1))/2 + min] for quality pairs
    (Context.h initializeMatchToMatchProb, the Jacobian log10-sum
    table at step 1e-4)."""
    step = 1e-4
    jac = np.log10(1.0 + 10.0 ** (-np.arange(int(8.0 / step) + 1) * step))
    out = np.zeros(((MAX_QUAL + 1) * (MAX_QUAL + 2)) // 2)
    idx = 0
    for i in range(MAX_QUAL + 1):
        for j in range(i + 1):
            small, big = -0.1 * i, -0.1 * j
            diff = big - small
            s = big if diff >= 8.0 else big + jac[int(diff / step + 0.5)]
            with np.errstate(divide="ignore"):
                out[idx] = 10.0 ** (np.log1p(-min(1.0, 10.0 ** s))
                                    * 0.434294)
            idx += 1
    return out


def ph2pr(q):
    return 10.0 ** (-np.clip(np.asarray(q, np.float64), 0, 127) / 10.0)


def transitions(iq, dq, cq):
    """(tMM, tGM, tMX, tXX, tMY, tYY), each [..] float64."""
    iq, dq = np.asarray(iq, np.int64), np.asarray(dq, np.int64)
    hi, lo = np.maximum(iq, dq), np.minimum(iq, dq)
    g = ph2pr(cq)
    return (match_to_match()[(hi * (hi + 1)) // 2 + lo], 1.0 - g, ph2pr(iq),
            g, ph2pr(dq), g)


def bf16(x):
    """x rounded to bfloat16 (to nearest, ties to even), as float64."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def forward(reads, rlens, q, iq, dq, cq, haps, hlens, bf16_=False):
    """log10 likelihood of each pair (rows of the arrays), float64;
    with bf16_ every value rounded to bfloat16."""
    rd = (lambda a: bf16(a)) if bf16_ else (lambda a: a)
    reads, haps = np.asarray(reads), np.asarray(haps)
    NP, R = reads.shape
    H = haps.shape[1]
    rl, hl = np.asarray(rlens, np.int64), np.asarray(hlens, np.int64)
    t = [rd(x) for x in transitions(iq, dq, cq)]
    e = ph2pr(q)
    one_m, e3 = rd(1.0 - e), rd(e / 3.0)
    hap = np.concatenate([np.full((NP, 1), 4, haps.dtype), haps], axis=1)
    M = np.zeros((NP, H + 1))
    X = np.zeros((NP, H + 1))
    init = 2.0 ** 1020 if not bf16_ else 2.0 ** 120
    Y = np.repeat(rd(init / hl)[:, None], H + 1, axis=1)
    out = np.zeros(NP)
    for i in range(int(rl.max(initial=0))):
        rb = reads[:, i:i + 1]
        match = (hap == rb) | (hap >= 4) | (rb >= 4)
        prior = np.where(match, one_m[:, i:i + 1], e3[:, i:i + 1])
        tMM, tGM, tMX, tXX, tMY, tYY = (x[:, i:i + 1] for x in t)
        Mi = np.zeros_like(M)
        Mi[:, 1:] = rd(prior[:, 1:] * rd(
            rd(M[:, :-1] * tMM) + rd(tGM * rd(X[:, :-1] + Y[:, :-1]))))
        Xi = np.zeros_like(X)
        Xi[:, 1:] = rd(rd(M[:, 1:] * tMX) + rd(X[:, 1:] * tXX))
        Yi = np.zeros_like(Y)
        a = rd(Mi[:, :-1] * tMY)
        for j in range(1, H + 1):
            Yi[:, j] = rd(a[:, j - 1] + rd(tYY[:, 0] * Yi[:, j - 1]))
        M, X, Y = Mi, Xi, Yi
        last = rl == i + 1
        if last.any():
            cols = np.arange(H + 1)[None, :]
            s = np.where((cols >= 1) & (cols <= hl[last][:, None]),
                         M[last] + X[last], 0.0)
            acc = np.zeros(int(last.sum()))
            for j in range(1, H + 1):
                acc = rd(acc + s[:, j])
            out[last] = np.log10(np.maximum(acc, np.finfo(float).tiny))
    return out - (LOG10_SCALE if not bf16_ else 120 * np.log10(2.0))
