"""Base encoding and sequence utilities.

Encoding follows the bwa convention (A=0, C=1, G=2, T=3, N/other=4);
ambiguous bases are replaced by a deterministic pseudo-random base at index
build time, mirroring bns_fasta2bntseq (reference:
bwa-mem2-lcp/ext/TAL/ext/bntseq.cpp, nst_nt4_table).
"""

from __future__ import annotations

import numpy as np

# nst_nt4_table equivalent: ASCII -> code
_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _LUT[ord(_c)] = _i
    _LUT[ord(_c.lower())] = _i

COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0..4}."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return BASES[codes].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes[::-1]]


def randomize_ambiguous(codes: np.ndarray, seed: int = 11) -> np.ndarray:
    """Replace code-4 (N) bases with deterministic pseudo-random ACGT.

    The reference does the same during pac construction so that the
    FM-index text is strictly 4-letter (bntseq.cpp, lrand48-based); we use a
    fixed-seed generator for reproducible indexes.
    """
    out = codes.copy()
    n_mask = out == 4
    n_amb = int(n_mask.sum())
    if n_amb:
        rng = np.random.default_rng(seed)
        out[n_mask] = rng.integers(0, 4, size=n_amb, dtype=np.uint8)
    return out


def pack_2bit_words(codes: np.ndarray, bases_per_word: int = 16) -> np.ndarray:
    """Pack 2-bit codes little-endian into uint32 words.

    word[k] holds codes[16k .. 16k+15]; code j sits at bits (2j, 2j+1).
    Input must be strictly in {0..3}; pads the tail with zeros.
    """
    assert codes.max(initial=0) <= 3
    n = len(codes)
    n_words = -(-n // bases_per_word)
    padded = np.zeros(n_words * bases_per_word, dtype=np.uint32)
    padded[:n] = codes
    padded = padded.reshape(n_words, bases_per_word)
    shifts = (2 * np.arange(bases_per_word, dtype=np.uint32))[None, :]
    return (padded << shifts).sum(axis=1, dtype=np.uint32)
