"""Repeat-rich synthetic genome, the benchmark's own copy.

A copy of scripts/gen_genome.py's generator (its vectorised background
and its repeat families), kept here so that a change to the program's
scripts cannot move the yardstick: a 2nd-order composition background
that drifts per 100 kb isochore, an Alu-like SINE family (300 bp, ~10%
of the genome at 10% divergence), a LINE-like family (3 kb consensus,
truncated copies, ~8%), microsatellites (~2%) and segmental
duplications (10-50 kb at 1% divergence).

The genome of a configuration is drawn from the configuration's own
seed, never from a run's --seed: a deployment aligns many samples to
one reference.
"""

from __future__ import annotations

import numpy as np


def markov_fast(rng, n):
    """Unique background: i.i.d. draws under a GC profile that drifts
    per 100 kb isochore."""
    iso = 100_000
    blocks = []
    for b0 in range(0, n, iso):
        ln = min(iso, n - b0)
        gc = rng.beta(5, 5) * 0.3 + 0.35
        pa = (1 - gc) / 2
        p = np.array([pa, gc / 2, gc / 2, pa])
        blocks.append(rng.choice(4, size=ln, p=p).astype(np.uint8))
    return np.concatenate(blocks)[:n]


def mutate(rng, s, div):
    s = s.copy()
    m = rng.random(len(s)) < div
    s[m] = rng.integers(0, 4, int(m.sum()))
    return s


def generate(n, seed=0):
    """uint8[n] codes 0..3 (n above 50,000: the duplications need room)."""
    rng = np.random.default_rng(seed)
    g = markov_fast(rng, n)

    alu = rng.integers(0, 4, 300).astype(np.uint8)
    for p in rng.integers(0, n - 400, int(n * 0.10 / 300)):
        c = mutate(rng, alu, 0.10)
        if rng.random() < 0.5:
            c = (3 - c)[::-1]
        g[p:p + 300] = c

    line = rng.integers(0, 4, 3000).astype(np.uint8)
    for p in rng.integers(0, n - 3100, int(n * 0.08 / 1500)):
        ln = int(rng.integers(500, 3000))
        c = mutate(rng, line[-ln:], 0.08)
        if rng.random() < 0.5:
            c = (3 - c)[::-1]
        g[p:p + ln] = c

    for p in rng.integers(0, n - 1200, int(n * 0.02 / 120)):
        u = int(rng.integers(1, 7))
        unit = rng.integers(0, 4, u).astype(np.uint8)
        reps = int(rng.integers(20, 1000 // max(u, 1)))
        seg = np.tile(unit, reps)[:1100]
        g[p:p + len(seg)] = mutate(rng, seg, 0.02)

    for _ in range(max(2, n // 10_000_000)):
        ln = int(rng.integers(10_000, 50_000))
        src = int(rng.integers(0, n - ln))
        dst = int(rng.integers(0, n - ln))
        g[dst:dst + ln] = mutate(rng, g[src:src + ln], 0.01)
    return g
