"""Device RMI lookup + chunked exact search, and inexact search (torch).

Port of the JAX package's ops/exact.py, the device half of the LISA
analogue (index/rmi.py): one float32 model prediction + a bounded
lockstep bisection resolves the SA interval of a 13-char chunk; the
remaining pattern chars extend backward 2-per-gather-pair through the
fused FM rows. Mirrors FMI_search::exact_search
(ext/TAL/src/FMI/FMI_search.cpp:2374) and LISA
exact_search_rmi_batched_k3 (LISA-FMI/LISA_search.h:180).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..index.rmi import RMIndex
from ..utils.device import resolve_device
from . import fm as fmops

_I32 = torch.int32


class DeviceRMI(NamedTuple):
    keys: torch.Tensor        # int32[N] sorted
    slope: torch.Tensor       # float32[n_leaves]
    intercept: torch.Tensor   # float32[n_leaves]
    err_lo: torch.Tensor      # int32[n_leaves]
    err_hi: torch.Tensor      # int32[n_leaves]
    starts: torch.Tensor      # int32[n_leaves+1]
    shift: int
    k: int

    @classmethod
    def from_host(cls, r: RMIndex, device=None) -> "DeviceRMI":
        """device=None places the tensors on the CUDA card (raises without
        one); pass device="cpu" for the CPU."""
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(a, device=dev)
        return cls(keys=t(r.keys), slope=t(r.slope),
                   intercept=t(r.intercept), err_lo=t(r.err_lo),
                   err_hi=t(r.err_hi), starts=t(r.starts),
                   shift=int(r.shift), k=int(r.k))


def _searchsorted_left(rmi: DeviceRMI, q):
    """Lockstep searchsorted-left for int32 queries q[B]: radix leaf ->
    model window intersected with the leaf row range -> bisection."""
    n_leaves = rmi.slope.shape[0]
    N = rmi.keys.shape[0]
    leaf = (q >> rmi.shift).clamp(0, n_leaves - 1).long()
    # the error bounds were computed with an unfused float32 multiply,
    # then an add (index/rmi.py): two separate ops here too, and the
    # int32 cast truncates toward zero as numpy's astype does
    prod = q.to(torch.float32) * rmi.slope[leaf]
    pred = (prod + rmi.intercept[leaf]).to(_I32)
    lo = torch.maximum(pred - rmi.err_lo[leaf], rmi.starts[leaf])
    hi = torch.minimum(pred + rmi.err_hi[leaf] + 1, rmi.starts[leaf + 1])
    lo = lo.clamp(0, N)
    hi = torch.minimum(torch.maximum(hi, lo), torch.full_like(hi, N))
    for _ in range(32):
        mid = (lo + hi) >> 1
        kv = rmi.keys[mid.clamp(0, N - 1).long()]
        lt = (kv < q) & (lo < hi)      # converged lanes must not drift
        lo, hi = torch.where(lt, mid + 1, lo), torch.where(lt, hi, mid)
    return lo


def rmi_interval(rmi: DeviceRMI, qkeys):
    """(k, s) SA interval of packed 13-char patterns qkeys int32[B]."""
    lo = _searchsorted_left(rmi, qkeys)
    hi = _searchsorted_left(rmi, qkeys + 1)
    return lo, hi - lo


def _col(codes, p):
    """codes[b, p_b] with p clamped into the row."""
    L = codes.shape[1]
    return codes.gather(1, p.clamp(0, L - 1).long()[:, None])[:, 0]


def pack_patterns(codes, start, k: int):
    """Pack k chars of codes[B, L] from per-lane offsets start[B] base-5
    (+1 digit). Returns (qkeys int32[B], ok bool[B]: all chars ACGT)."""
    B, L = codes.shape
    key = torch.zeros(B, dtype=_I32, device=codes.device)
    ok = torch.ones(B, dtype=torch.bool, device=codes.device)
    for j in range(k):
        p = start + j
        a = _col(codes, p)
        ok = ok & (a < 4) & (p < L)
        key = key * 5 + a.clamp(0, 3).to(_I32) + 1
    return key, ok


def exact_search(fm: fmops.DeviceFMIndex, rmi: DeviceRMI, codes, lens):
    """Full-pattern exact search: interval of the whole read.

    codes int32[B, L] (0-3, >=4 ambiguous), lens int32[B]. Returns
    (k, s) int32[B]; s == 0 when the pattern does not occur. Patterns
    shorter than the RMI chunk use a pure FM backward walk.
    """
    K = rmi.k
    lens = lens.to(_I32)
    # chunk start: the LAST K chars (backward search prepends leftward)
    cstart = (lens - K).clamp(min=0)
    qkeys, okq = pack_patterns(codes, cstart, K)
    k0, s0 = rmi_interval(rmi, qkeys)
    long_lane = lens >= K
    # short lanes: init from the last char
    last = _col(codes, (lens - 1).clamp(min=0))
    ik, _, is_ = fmops.init_interval(fm, last)
    k = torch.where(long_lane, k0, ik)
    s = torch.where(long_lane, torch.where(okq, s0, 0),
                    torch.where((last < 4) & (lens > 0), is_, 0))
    # remaining chars to prepend: positions rem-1 .. 0
    rem = torch.where(long_lane, cstart, (lens - 1).clamp(min=0))
    t = 0
    while bool(((t < rem) & (s > 0)).any()):
        # prepend chars at rem-1-t (c2) then rem-2-t (c1): one gather pair
        j2 = rem - 1 - t
        j1 = j2 - 1
        a2 = _col(codes, j2)
        a1 = _col(codes, j1)
        k1, s1, k2, s2 = fmops.backward_extend2(fm, k, s, a2, a1)
        go2 = (j2 >= 0) & (t < rem) & (s > 0)
        ok2 = go2 & (a2 < 4)
        kA = torch.where(ok2, k1, k)
        sA = torch.where(go2, torch.where(ok2, s1, 0), s)
        go1 = ok2 & (j1 >= 0) & (sA > 0)
        ok1 = go1 & (a1 < 4)
        k = torch.where(ok1, k2, kA)
        s = torch.where(go1, torch.where(ok1, s2, 0), sA)
        t += 2
    return k, torch.where(lens > 0, s, 0)


# FIFO states popped per lane a step (see inexact_search)
POP = 32


def inexact_search(fm: fmops.DeviceFMIndex, codes, lens, z: int,
                   max_out: int, fifo_cap: int | None = None):
    """Backtracking search with up to z mismatches — FMI_search::
    inexact_search (ext/TAL/src/FMI/FMI_search.cpp:2494-2660): BFS over
    (k, l, i, z) states from (0, N, L-1, z); z == 0 states extend with
    the query char only, z > 0 states branch over all four bases
    (mismatches decrement z); states that consume the whole query emit
    their (k, s) range.

    The JAX package pops one state a lane per loop step. Here a step
    pops up to POP states, those already queued when it starts, and
    appends their children in pop order, so every state lands in the
    same ring slot and every emission in the same output slot as one
    pop at a time would put it. The ring-capacity test is that of the
    one-pop loop, state by state; a lane whose test fails at a state
    stops its step there, so the states after it see the same
    occupancy. On a repeat-rich genome a read-length pattern queues
    thousands of states, so this divides the loop's host round trips by
    up to POP.

    codes int32[B, L], lens int32[B]. Returns (k int32[B, max_out],
    s int32[B, max_out], count int32[B], overflow bool[B]).
    """
    B, L = codes.shape
    dev = codes.device
    F = fifo_cap if fifo_cap is not None else 4 * L * max(z, 1) + 8
    N = fm.text_len
    lens = lens.to(_I32)
    # the FIFO ring: one row of (k, l, i, z) a state; row F takes the
    # writes of branches that are not pushed
    fifo = torch.zeros((B, F + 1, 4), dtype=_I32, device=dev)
    fifo[:, 0, 1] = N
    fifo[:, 0, 2] = lens - 1
    fifo[:, 0, 3] = z
    head = torch.zeros(B, dtype=_I32, device=dev)
    size = torch.ones(B, dtype=_I32, device=dev)
    # column max_out takes the writes of states that do not emit
    out = torch.zeros((B, max_out + 1, 2), dtype=_I32, device=dev)
    n = torch.zeros(B, dtype=_I32, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    t = torch.arange(POP, dtype=_I32, device=dev)[None, :]    # [1, POP]
    carange = torch.arange(4, dtype=_I32, device=dev)
    counts4 = fm.counts[:4].to(_I32)
    excl = lambda a: torch.cumsum(a, dim=1, dtype=_I32) - a

    while bool((head < size).any()):
        popped = t < (size - head).clamp(max=POP)[:, None]      # [B, POP]
        at = ((head[:, None] + t) % F).long()
        k, l, i, zz = fifo.gather(
            1, at[..., None].expand(B, POP, 4)).unbind(2)

        # branches: all four intervals from two gathers a state
        sp = counts4 + fmops.occ4(fm, k)                      # [B, POP, 4]
        ep = counts4 + fmops.occ4(fm, l)
        qc = codes.gather(1, i.clamp(0, L - 1).long())
        is_q = carange == qc[..., None]
        branch_ok = (sp < ep) & popped[..., None] & (i >= 0)[..., None] \
            & ((zz > 0)[..., None] | is_q)
        nb = branch_ok.sum(dim=2, dtype=_I32)                 # [B, POP]
        # the one-pop loop's ring test at each state: the popped head
        # slot is already free, hence the +1
        room = size[:, None] + excl(nb) - (head[:, None] + t) + nb <= F + 1
        fail = popped & ~room
        # a lane stops its step at its first failing state
        stop = torch.where(fail.any(dim=1),
                           fail.to(torch.uint8).argmax(dim=1).to(_I32) + 1,
                           POP)
        popped = popped & (t < stop[:, None])
        ovf = ovf | (popped & ~room).any(dim=1)
        push = branch_ok & (popped & room)[..., None]

        # emission: i < 0 -> output (k, s), in pop order
        emit = popped & (i < 0)
        slot = n[:, None] + excl(emit.to(_I32))
        can = emit & (slot < max_out)
        col = torch.where(can, slot, max_out).long()
        out.scatter_(1, col[..., None].expand(B, POP, 2),
                     torch.stack([k, l - k], dim=2))
        n = n + can.sum(dim=1, dtype=_I32)
        ovf = ovf | (emit & ~can).any(dim=1)

        # push the children at size, size+1, ... in (state, c) order
        flat = push.reshape(B, 4 * POP)
        seq = size[:, None] + torch.cumsum(flat.to(_I32), dim=1,
                                           dtype=_I32) - 1
        row = torch.where(flat, seq % F, F).long()
        nz = torch.where(is_q, zz[..., None], zz[..., None] - 1)
        rows = torch.stack([sp, ep, (i - 1)[..., None].expand(B, POP, 4),
                            nz], dim=3).reshape(B, 4 * POP, 4)
        fifo.scatter_(1, row[..., None].expand(B, 4 * POP, 4), rows)
        size = size + flat.sum(dim=1, dtype=_I32)
        head = head + popped.sum(dim=1, dtype=_I32)
    return (out[:, :max_out, 0].contiguous(),
            out[:, :max_out, 1].contiguous(), n, ovf)
