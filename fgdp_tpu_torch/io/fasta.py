"""FASTA reading and the packed multi-contig reference model.

Plays the role of the reference's bntseq layer (bwa-mem2-lcp/ext/TAL/ext/
bntseq.cpp): contigs are concatenated into one coordinate space, packed
2-bit, with ambiguous bases recorded then randomized. The unified
coordinate table also serves sortmardup's kTable (sortmardup/main.cpp:96-103).
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np

from ..utils import dna


@dataclasses.dataclass
class Reference:
    """Concatenated multi-contig reference.

    codes: uint8[L] in {0..3} (ambiguity randomized; see amb_mask)
    names: contig names, offsets[i] = start of contig i, offsets[-1] = L
    amb_mask: bool[L], True where the original base was non-ACGT
    """

    names: list
    offsets: np.ndarray          # int64[n_contigs+1]
    codes: np.ndarray            # uint8[L]
    amb_mask: np.ndarray         # bool[L]

    @property
    def length(self) -> int:
        return int(self.offsets[-1])

    @property
    def n_contigs(self) -> int:
        return len(self.names)


def _open(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path, randomize_seed: int = 11) -> Reference:
    names, seqs = [], []
    cur = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if names:
                    seqs.append(b"".join(cur))
                    cur = []
                names.append(line[1:].split()[0].decode())
            else:
                cur.append(line)
    if names:
        seqs.append(b"".join(cur))
    if not names:
        raise ValueError(f"empty FASTA: {path}")

    codes_list = [dna.encode(s) for s in seqs]
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(c) for c in codes_list])
    codes = np.concatenate(codes_list) if codes_list else np.zeros(0, np.uint8)
    amb_mask = codes == 4
    codes = dna.randomize_ambiguous(codes, seed=randomize_seed)
    return Reference(names=names, offsets=offsets, codes=codes, amb_mask=amb_mask)
