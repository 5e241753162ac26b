"""The plain reference's comparison for the somatic caller: the PairHMM
likelihoods that the window's launches returned, recomputed in float64
from the same pairs (reference/pairhmm.py), and the calls at the
planted sites.

Numbers (each at most its limit in the cell's file):
  hmm_max_abs_log10  the widest gap, over `hmm_sample` pairs drawn from
                     the seed among those the window's launches computed,
                     between the log10 likelihood the program returned
                     and the reference's
  hmm_unchecked      1 when the window's launches left no pair to
                     compare, else 0
Readings (not compared: no control separates them):
  somatic_missed_pct planted somatic SNVs of the targets fed with no call
                     at their position and allele (any filter)
  germline_called_pct germline heterozygous sites of the targets fed that
                     were called somatic (any filter)

The pairs are the program's: its haplotypes (its assembly's answer) and
the qualities its read preparation gave (base qualities capped and
squashed, insertion and deletion qualities from its PCR indel model).
The reference reads them to judge the likelihoods; it does not work out
the assembly or the qualities again.
"""

from __future__ import annotations

import numpy as np

from reference import pairhmm


def drawn_pairs(ctx, kept):
    """hmm_sample of the kept pairs, padded to one width: (reads, rlens,
    q, iq, dq, cq, haps, hlens, program log10)."""
    if not kept:
        return None
    R = max(k[0].shape[1] for k in kept)
    H = max(k[6].shape[1] for k in kept)

    def pad(a, w):
        return np.pad(a, ((0, 0), (0, w - a.shape[1])))
    cols = [np.concatenate([pad(k[c], R if c in (0, 2, 3, 4, 5) else H)
                            if k[c].ndim == 2 else k[c] for k in kept])
            for c in range(9)]
    rng = np.random.default_rng([int(ctx.seed) % (1 << 64), 9])
    n = len(cols[1])
    pick = np.sort(rng.choice(n, min(ctx.cell["hmm_sample"], n),
                              replace=False))
    return [c[pick] for c in cols]


def hmm_gap(pairs, bf16=False):
    """Widest |program - reference| log10 gap over the pairs (with
    bf16, the control's: the reference in bfloat16 in the program's
    place)."""
    ref = pairhmm.forward(*pairs[:8])
    got = pairhmm.forward(*pairs[:8], bf16_=True) if bf16 else pairs[8]
    return float(np.max(np.abs(got - ref)))


def judge(ctx, run):
    pairs = drawn_pairs(ctx, run.pairs)
    out = {"hmm_unchecked": int(pairs is None),
           "hmm_max_abs_log10": hmm_gap(pairs) if pairs else 0.0}
    sl, fed = run.slice, run.fed
    called = {(c.pos, c.alt) for c in run.calls}
    lut = "ACGT"
    som = [(p, lut[a]) for t, (p, a, _) in sl.somatic.items() if t < fed]
    germ = [(p, lut[a]) for t in range(fed) for p, a in sl.germline[t]]
    out["somatic_missed_pct"] = 100.0 * sum(s not in called for s in som) \
        / max(len(som), 1)
    out["germline_called_pct"] = 100.0 * sum(g in called for g in germ) \
        / max(len(germ), 1)
    return out
