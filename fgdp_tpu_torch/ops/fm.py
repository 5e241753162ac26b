"""Batched FM-index rank/extension ops (device side, torch).

The reference extends ONE bi-interval per call with SSE popcounts
(bwa-mem2-lcp/src/bwt.cpp:278-1065, ext/TAL FMI_search.cpp backwardExt
:1841). Here a whole batch of intervals extends per call: each occ
lookup is a row gather from the device-resident fused checkpoint rows,
and the within-block rank is a masked 2-bit compare + popcount over the
batch, exactly as in the JAX package (fgdp_tpu/ops/fm.py).

Two-step ("lambert") extension: one fused row holds single-char AND
dinucleotide checkpoints plus both packed BWT columns (B, B1), so the
same two gathers that answer a 1-step extension also answer the 2-step
extension (src/bwt.h:64-67, src/bwt.cpp:278-1065).

Interval coordinates are int32 at every public function, as in the JAX
package. The packed BWT words are uint32 values; torch has no uint32
arithmetic, so the bit work runs in int64 and masks to 32 bits, and the
popcount is a SWAR reduction (torch has no popcount op).

The two big tables (occ_fused, sa) are read through one helper,
`gather_rows`, so that they may also be row-sharded across the ranks of
a process group (parallel/mesh.shard_index): each rank holds a
contiguous block of rows, gathers the ones it owns, writes zeros for
the rest, and an all_reduce(SUM) over the group completes every row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..index.fmindex import FMIndex, OCC_BLOCK
from ..utils.device import resolve_device

_EVEN = 0x55555555
_FULL = 0xFFFFFFFF
_I32 = torch.int32


class ShardedRows:
    """This rank's contiguous block of a row-sharded table: global rows
    [start, start + len(local)) of a table of `rows` rows (the last
    rank's block may run past `rows` into padding, which no clamped
    index reaches). Every rank of `group` holds one block."""

    def __init__(self, local: torch.Tensor, start: int, rows: int, group):
        self.local = local
        self.start = start
        self.rows = rows
        self.group = group


def table_rows(table) -> int:
    """Row count of a table, global for a sharded one."""
    return table.rows if isinstance(table, ShardedRows) else table.shape[0]


def is_sharded(fm) -> bool:
    """Whether the occ rows or the SA of `fm` are a ShardedRows block (the
    fm-sharded mesh). The seeding kernels take whole tables: a gather
    from a sharded one is an all_reduce, which a kernel cannot make, so
    these run the torch-op loops."""
    return isinstance(fm.occ_fused, ShardedRows) or \
        isinstance(fm.sa, ShardedRows)


def gather_rows(table, idx):
    """table[idx] with idx clamped to the table's rows (the JAX package's
    mode="clip"). For a sharded table every rank of its group must make
    the same call: the rows this rank owns are gathered, the rest are
    zeros, and all_reduce(SUM) over the group fills them in (a value
    plus zeros is exact in int32)."""
    idx = idx.long().clamp(0, table_rows(table) - 1)
    if not isinstance(table, ShardedRows):
        return table[idx]
    import torch.distributed as dist

    loc = idx - table.start
    n = table.local.shape[0]
    mine = (loc >= 0) & (loc < n)
    out = table.local[loc.clamp(0, n - 1)]
    out = torch.where(mine.reshape(mine.shape + (1,) * (out.dim()
                                                        - mine.dim())),
                      out, 0)
    dist.all_reduce(out, group=table.group)
    return out


class DeviceFMIndex(NamedTuple):
    """FM-index tensors resident on the aligner's device. See
    index/fmindex.py for the layout.

    occ_fused row (24 x int32 per 32-suffix block): cols 0-3 single-char
    cumulative counts, 4-19 dinucleotide cumulative counts, 20-21 packed
    B words, 22-23 packed B1 words. One gather row answers every rank
    query an extension needs."""

    counts: torch.Tensor       # int32[5]   C array (sentinel rank 0)
    c2: torch.Tensor           # int32[17]  dinucleotide first-row array
    occ_fused: torch.Tensor    # int32[nblocks, 24]  (or ShardedRows)
    sa: torch.Tensor           # int32[N] full suffix array (or ShardedRows)
    sentinel_row: int          # r0: B packs $ as code 0
    r1_row: int                # B1 packs $ as code 0
    cc_r0: int                 # spurious pair code at r0
    cc_r1: int                 # spurious pair code at r1
    n_ref: int                 # forward reference length
    text_len: int              # N = 2*n_ref + 1

    @classmethod
    def from_host(cls, fm: FMIndex, device=None) -> "DeviceFMIndex":
        """device=None places the tensors on the CUDA card (raises without
        one); pass device="cpu" for the CPU."""
        if OCC_BLOCK != 32:
            raise ValueError("rank ops assume two uint32 words per block")
        nblocks = fm.occ.shape[0]
        fused = np.zeros((nblocks, 24), np.int32)
        fused[:, :4] = fm.occ
        fused[:, 4:20] = fm.occ2
        fused[:, 20:22] = fm.bwt_words.view(np.int32)
        fused[:, 22:24] = fm.bwt1_words.view(np.int32)
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        return cls(
            counts=t(fm.counts), c2=t(fm.c2), occ_fused=t(fused),
            sa=t(fm.sa),
            sentinel_row=int(fm.sentinel_row), r1_row=int(fm.r1_row),
            cc_r0=int(fm.cc_r0), cc_r1=int(fm.cc_r1),
            n_ref=int(fm.n_ref), text_len=int(fm.text_len))


def popcount32(x):
    """Set bits of int64 tensors holding uint32 values (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _sel(b0, b1, c: int):
    """Bit mask (even positions) of codes == c in a packed word, from its
    precomputed low/high bitplanes."""
    m0 = b0 if (c & 1) else ~b0
    m1 = b1 if (c & 2) else ~b1
    return m0 & m1 & _EVEN


def _prefix_masks(rem):
    """Per-word in-block prefix masks for rem in [0, 32]: bits of code
    slots < rem. Returns (mask_w0, mask_w1) as int64 uint32 values."""
    b0 = rem.clamp(0, 16)
    b1 = (rem - 16).clamp(0, 16)

    def mk(bits):
        return torch.where(bits >= 16, _FULL, (1 << (bits << 1)) - 1)

    return mk(b0), mk(b1)


def _row(fm: DeviceFMIndex, i):
    """Fused checkpoint row of position i (gather clamped to the table,
    the JAX package's mode="clip"), its packed words as uint32 values in
    int64, and the in-block prefix masks."""
    i = i.long()
    row = gather_rows(fm.occ_fused, i >> 5)                  # (..., 24)
    words = row[..., 20:24].long() & _FULL
    return row, words, _prefix_masks(i & 31)


class _RowRanks(NamedTuple):
    """Decoded fused checkpoint row at position i."""

    occ1: torch.Tensor        # int32[..., 4]  sentinel-corrected
    occ2c: torch.Tensor       # int32[..., 4]  pairs (c1, c2fix), c1 = 0..3
    i: torch.Tensor


def _fetch(fm: DeviceFMIndex, i, c2fix):
    """Gather + decode the checkpoint row at i. occ1 for all 4 chars;
    occ2 for the 4 dinucleotides whose SECOND char is c2fix."""
    i = i.to(_I32)
    row, words, pref = _row(fm, i)
    base1 = row[..., :4]
    base2 = row[..., 4:20]
    planes = [(words[..., w] & _EVEN, (words[..., w] >> 1) & _EVEN)
              for w in range(4)]

    def popc2(mask_fn):
        return sum(popcount32(mask_fn(w) & pref[w]) for w in range(2))

    cnts = [popc2(lambda w, c=c: _sel(planes[w][0], planes[w][1], c))
            for c in range(4)]
    occ1 = base1 + torch.stack(cnts, dim=-1).to(_I32)
    sent_fix = (i > fm.sentinel_row).to(_I32)
    occ1 = torch.cat([(occ1[..., 0] - sent_fix)[..., None], occ1[..., 1:]],
                     dim=-1)

    c2fix = c2fix.clamp(0, 3).long()
    mB = []
    for w in range(2):
        opts = torch.stack(
            [_sel(planes[w][0], planes[w][1], c) for c in range(4)], dim=-1)
        mB.append(torch.gather(opts, -1, c2fix[..., None])[..., 0])
    cnts2 = [popc2(lambda w, c1=c1: mB[w]
                   & _sel(planes[w + 2][0], planes[w + 2][1], c1))
             for c1 in range(4)]
    ccs = torch.arange(4, device=i.device) * 4 + c2fix[..., None]
    base2sel = torch.gather(base2, -1, ccs)
    occ2c = base2sel + torch.stack(cnts2, dim=-1).to(_I32)
    fix0 = (ccs == fm.cc_r0) & (i > fm.sentinel_row)[..., None]
    fix1 = (ccs == fm.cc_r1) & (i > fm.r1_row)[..., None]
    occ2c = occ2c - fix0.to(_I32) - fix1.to(_I32)
    return _RowRanks(occ1=occ1, occ2c=occ2c, i=i)


def occ4(fm: DeviceFMIndex, i):
    """Occ(c, i) for all four bases at once; i int32[...] -> int32[..., 4]."""
    return _fetch(fm, i, torch.zeros_like(i)).occ1


def _pick(v, c):
    """v[..., c] for a per-element index c."""
    return torch.gather(v, -1, c.long()[..., None])[..., 0]


def _bwd_from_ranks(fm, lo: _RowRanks, hi: _RowRanks, l, c):
    """backward_extend given decoded rows at k and k+s."""
    sizes = hi.occ1 - lo.occ1
    sent_in = ((lo.i <= fm.sentinel_row)
               & (fm.sentinel_row < hi.i)).to(_I32)
    l3 = l + sent_in
    l2 = l3 + sizes[..., 3]
    l1 = l2 + sizes[..., 2]
    l0 = l1 + sizes[..., 1]
    ls = torch.stack([l0, l1, l2, l3], dim=-1)
    cc = c.clamp(0, 3).long()
    new_k = fm.counts[cc] + _pick(lo.occ1, cc)
    return new_k, _pick(ls, cc), _pick(sizes, cc)


def backward_extend(fm: DeviceFMIndex, k, l, s, c):
    """Prepend base c to the pattern of bi-interval (k, l, s); batched.

    bwa bwt_extend(is_back=1) semantics. Lanes with s <= 0 or invalid c
    must be masked by the caller (outputs are then meaningless but
    finite)."""
    k = k.to(_I32)
    s = s.to(_I32)
    cc = c.clamp(0, 3).to(_I32)
    lo = _fetch(fm, k, cc)
    hi = _fetch(fm, k + s, cc)
    return _bwd_from_ranks(fm, lo, hi, l.to(_I32), cc)


def _sel_dyn(b0, b1, c):
    """Bit mask (even positions) of codes == c for a per-element char c:
    XOR flips planes where the target bit is 0, so matches become set
    bits."""
    e0 = torch.where((c & 1) == 1, 0, _EVEN)
    e1 = torch.where((c & 2) == 2, 0, _EVEN)
    return (b0 ^ e0) & (b1 ^ e1) & _EVEN


def _fetch_pair(fm: DeviceFMIndex, i, c2, pair):
    """Lean row decode for the backward direction: only Occ(c2, i) and
    Occ2((c1, c2), i). Returns (occ1_c2, occ2_pair)."""
    i = i.to(_I32)
    row, words, pref = _row(fm, i)
    base1 = _pick(row[..., :4], c2)
    base2 = _pick(row[..., 4:20], pair)
    c1 = (pair >> 2).long()
    c2l = c2.long()
    n1 = n2 = 0
    for w in range(2):
        ww = words[..., w]
        mB = _sel_dyn(ww & _EVEN, (ww >> 1) & _EVEN, c2l)
        w1 = words[..., w + 2]
        mB1 = _sel_dyn(w1 & _EVEN, (w1 >> 1) & _EVEN, c1)
        n1 = n1 + popcount32(mB & pref[w])
        n2 = n2 + popcount32(mB & mB1 & pref[w])
    occ1 = base1 + n1.to(_I32) \
        - ((c2 == 0) & (i > fm.sentinel_row)).to(_I32)
    occ2 = base2 + n2.to(_I32) \
        - ((pair == fm.cc_r0) & (i > fm.sentinel_row)).to(_I32) \
        - ((pair == fm.cc_r1) & (i > fm.r1_row)).to(_I32)
    return occ1, occ2


def backward_extend2(fm: DeviceFMIndex, k, s, c2, c1):
    """Prepend base c2, then base c1 (pattern P -> c1 c2 P), from the
    same two gathers (src/bwt.cpp:822-1065). Returns (k1, s1, k2, s2):
    the intermediate interval after c2 and the final after c1 c2."""
    k = k.to(_I32)
    s = s.to(_I32)
    cc2 = c2.clamp(0, 3).to(_I32)
    cc1 = c1.clamp(0, 3).to(_I32)
    pair = cc1 * 4 + cc2
    o1lo, o2lo = _fetch_pair(fm, k, cc2, pair)
    o1hi, o2hi = _fetch_pair(fm, k + s, cc2, pair)
    k1 = fm.counts[cc2.long()] + o1lo
    s1 = o1hi - o1lo
    k2 = fm.c2[pair.long()] + o2lo
    s2 = o2hi - o2lo
    return k1, s1, k2, s2


def forward_extend(fm: DeviceFMIndex, k, l, s, c):
    """Append base c to the pattern: backward extension of the
    reverse-complement interval with k/l swapped (FMI_search.cpp:1218-1227)."""
    bk, bl, bs = backward_extend(fm, l, k, s, 3 - c.clamp(0, 3))
    return bl, bk, bs


def forward_extend2(fm: DeviceFMIndex, k, l, s, ca, cb):
    """Append base ca, then cb (pattern P -> P·ca·cb), from the same two
    gathers (src/bwt.cpp:278-649). Returns ((k1, l1, s1), (k2, l2, s2)):
    intermediate and final bi-intervals."""
    k = k.to(_I32)
    l = l.to(_I32)
    s = s.to(_I32)
    ca3 = 3 - ca.clamp(0, 3).to(_I32)       # RC of first char
    cb3 = 3 - cb.clamp(0, 3).to(_I32)
    lo = _fetch(fm, l, ca3)
    hi = _fetch(fm, l + s, ca3)
    # intermediate: backward extension on the RC side by 3-ca
    bl1, bk1, s1 = _bwd_from_ranks(fm, lo, hi, k, ca3)
    k1, l1 = bk1, bl1
    # final: 2-step prepend (3-cb)(3-ca) on the RC side
    pair = cb3 * 4 + ca3
    l2 = fm.c2[pair.long()] + _pick(lo.occ2c, cb3)
    s2fwd_rc = hi.occ2c - lo.occ2c        # indexed by c1 = 3-d'
    s2 = _pick(s2fwd_rc, cb3)
    # forward sub-partition of [k1, k1+s1): '$' continuation first, then
    # increasing continuation char d' (= reversed c1 order)
    s2fwd = s2fwd_rc.flip(-1)             # indexed by d'
    end2 = s1 - s2fwd.sum(-1, dtype=_I32)
    cbc = cb.clamp(0, 3)
    before = torch.where(
        torch.arange(4, device=k.device) < cbc[..., None], s2fwd,
        0).sum(-1, dtype=_I32)
    k2 = k1 + end2 + before
    return (k1, l1, s1), (k2, l2, s2)


def init_interval(fm: DeviceFMIndex, c):
    """Bi-interval of the single-base pattern c (batched)."""
    cc = c.clamp(0, 3).long()
    k = fm.counts[cc]
    s = fm.counts[cc + 1] - k
    l = fm.counts[3 - cc]
    return k, l, s


def sa_lookup(fm: DeviceFMIndex, idx):
    """SA[idx] gather, clamped to the table (the JAX package's
    mode="clip")."""
    return gather_rows(fm.sa, idx)


def kernel_args(fm: DeviceFMIndex, dev, what: str):
    """(tensors to keep alive, the FM-index as the seeding kernels' C entry
    points take it: occ, nblocks, counts, c2, sa, sa_len, sentinel_row,
    r1_row, cc_r0, cc_r1). Raises unless the tables lie whole on `dev`."""
    from . import kernels

    if is_sharded(fm):
        raise ValueError(f"{what}: the kernel takes whole FM tables, not "
                         "ShardedRows blocks")
    occ, counts, c2, sa = (
        kernels.tensor_arg(t, dev, _I32, f"{what}: the FM index's {n}")
        for t, n in ((fm.occ_fused, "occ rows"), (fm.counts, "counts"),
                     (fm.c2, "c2"), (fm.sa, "SA")))
    keep = (occ, counts, c2, sa)
    return keep, [occ.data_ptr(), occ.shape[0], counts.data_ptr(),
                  c2.data_ptr(), sa.data_ptr(), sa.shape[0],
                  fm.sentinel_row, fm.r1_row, fm.cc_r0, fm.cc_r1]
