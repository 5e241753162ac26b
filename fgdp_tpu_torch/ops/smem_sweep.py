"""Packed read words and read windows (the parts of the JAX package's
ops/smem_sweep.py that the LCP seeding engine and the extension driver
use; the sweep machines themselves are not part of the port yet).

Packed words are uint32 values carried in int64 tensors: torch has no
uint32 arithmetic, and int64 keeps every shift and mask exact.
"""

from __future__ import annotations

import torch

WALK_T = 64          # chars per text-walk step

_U32 = 0xFFFFFFFF


def pack_reads(codes):
    """Pack int32[B, L] base codes into 2-bit words + N-flag words.

    Returns int64[B, W, 2] (words, nwords) with W = ceil(L/16) + 1 (one
    slack word so window fetches never index out of range). Codes >= 4
    pack as 0 with the N flag set."""
    B, L = codes.shape
    W = (L + 15) // 16 + 1
    pad = W * 16 - L
    c = torch.nn.functional.pad(codes.long(), (0, pad))
    isn = (c >= 4) | (c < 0)
    c2 = torch.where(isn, 0, c).reshape(B, W, 16)
    sh = (2 * torch.arange(16, device=codes.device))[None, None, :]
    words = (c2 << sh).sum(dim=2)
    nwords = (isn.long().reshape(B, W, 16) << sh).sum(dim=2)
    return torch.stack([words, nwords], dim=-1)


def read_window(packed, rid, start, lens_l, T: int):
    """Read codes [NL, T] at positions start..start+T-1 of read rid
    (4 = N / out of [0, len))."""
    Wf = (T + 15) // 16 + 1
    start = start.long()
    dev = packed.device
    w0 = start >> 4                          # floor for negative starts
    widx = (w0[:, None] + torch.arange(Wf, device=dev)[None, :]).clamp(
        0, packed.shape[1] - 1)
    rows = packed[rid.long()[:, None], widx]            # [NL, Wf, 2]
    wrows, nrows = rows[..., 0], rows[..., 1]
    off = start & 15
    sh = 2 * off[:, None]

    def align(ws):
        return torch.where(off[:, None] == 0, ws[:, :-1],
                           ((ws[:, :-1] >> sh) | (ws[:, 1:] << (32 - sh)))
                           & _U32)

    aw, an = align(wrows), align(nrows)
    cols = torch.arange(T, device=dev)
    wi = (cols >> 4).clamp(max=Wf - 2)
    bi = 2 * (cols & 15)
    c = (aw[:, wi] >> bi[None, :]) & 3
    nf = (an[:, wi] >> bi[None, :]) & 1
    pos = start[:, None] + cols[None, :]
    ok = (pos >= 0) & (pos < lens_l[:, None]) & (nf == 0)
    return torch.where(ok, c, 4).to(torch.int32)


def _read_base_at(codes, rid, j):
    """codes[rid, j] with out-of-range j -> 4."""
    B, L = codes.shape
    jj = j.clamp(0, L - 1).long()
    a = codes[rid.long(), jj].to(torch.int32)
    return torch.where((j >= 0) & (j < L), a, 4)
