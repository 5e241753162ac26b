"""Batched banded Smith-Waterman extension: kernel wrapper + plain version.

The reference runs per-pair banded SW in 8/16-bit AVX512 lanes
(BandedPairWiseSW, ext/TAL/src/alignment/BSW/bandedSWA.cpp; scalar
contract scalarBandedSWA :116-234 == bwa ksw_extend2). On the card the
hand-written kernel csrc/sw_extend.cu runs it, one warp per job with the
band state in registers (it replaces the TPU kernel
fgdp_tpu/ops/sw_pallas.py). `sw_extend_plain`
beside it is the same function as a row loop of torch ops, transcribed
from the JAX package's ops/sw.sw_extend: the CPU tests run it, and the
card's smoke run holds the kernel against it.

`sw_extend` takes the kernel for CUDA tensors and the plain version for
CPU tensors, and nothing else: a failing launch raises.

All arithmetic is int32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import host_read
from . import kernels

NEG_INF = -(1 << 30)
# the widest query the kernel takes: 32 lanes x SW_MAX_K columns hold the
# QP + 2 columns of the band state (csrc/sw_extend.cuh)
MAX_QP = 32 * 8 - 2
_I32 = torch.int32


class SWParams(NamedTuple):
    o_del: int
    e_del: int
    o_ins: int
    e_ins: int
    zdrop: int
    end_bonus: int  # pen_clip of the extension side (w-cap term only)
    mat_max: int    # match score a (also the max entry of the matrix)
    mat_mis: int = 4   # mismatch penalty b (positive)
    mat_amb: int = -1  # score vs N (bwa_fill_scmat: -1)


class SWResult(NamedTuple):
    score: torch.Tensor    # int32[B]
    qle: torch.Tensor      # int32[B] query consumed at local max
    tle: torch.Tensor      # int32[B] target consumed at local max
    gtle: torch.Tensor     # int32[B] target consumed at best to-query-end score
    gscore: torch.Tensor   # int32[B] best to-query-end score (-1 if none)
    max_off: torch.Tensor  # int32[B] max diagonal offset at improvements


def sw_extend(query, qlen, target, tlen, h0, w: int, p: SWParams,
              t_max: int | None = None) -> SWResult:
    """Batched extension SW. query int32[B, QP], target int32[B, TP]
    (codes 0..4), qlen/tlen/h0 int32[B], w the band width before
    per-lane clamping. Rows run up to min(t_max, TP). Lanes with
    qlen<=0 or tlen<=0 return (h0, 0, 0, 0, -1, 0)."""
    if t_max is not None and t_max < target.shape[1]:
        target = target[:, :t_max]
    if query.is_cuda:
        return sw_extend_kernel(query, qlen, target, tlen, h0, w, p)
    return sw_extend_plain(query, qlen, target, tlen, h0, w, p)


def sw_extend_kernel(query, qlen, target, tlen, h0, w: int, p: SWParams,
                     cells=None, rows=None) -> SWResult:
    """Launch csrc/sw_extend.cu on CUDA tensors. `cells` and `rows`,
    int64[B] CUDA tensors, receive the DP cells and the target rows each
    job computed when given."""
    J, QP = query.shape
    TP = target.shape[1]
    dev = query.device
    if QP > MAX_QP:
        raise ValueError(f"sw_extend kernel: query width {QP} above "
                         f"{MAX_QP}, the widest the kernel is built for")
    args = dict(query=query, qlen=qlen, target=target, tlen=tlen, h0=h0)
    query, qlen, target, tlen, h0 = (
        a.to(_I32).contiguous() for a in args.values())
    for name, a in zip(args, (query, qlen, target, tlen, h0)):
        if a.device != dev or not a.is_cuda:
            raise ValueError(f"sw_extend kernel: {name} is not on {dev}")
        if a.shape[0] != J:
            raise ValueError(f"sw_extend kernel: {name} has {a.shape[0]} "
                             f"rows, expected {J}")
    if qlen.dim() != 1 or tlen.dim() != 1 or h0.dim() != 1:
        raise ValueError("sw_extend kernel: qlen/tlen/h0 must be 1-D")
    # the kernel reads query row j up to qlen and keeps QP + 2 band cells;
    # a capture cannot read the card, and its caller's shapes bound qlen
    # by QP (align/extend.extend_chains)
    if J and not torch.cuda.is_current_stream_capturing() and \
            host_read(int, qlen.max()) > QP:
        raise ValueError(f"sw_extend kernel: qlen above the query width "
                         f"{QP}")
    for name, a in (("cells", cells), ("rows", rows)):
        if a is not None and (a.dtype != torch.int64 or a.shape != (J,)
                              or a.device != dev):
            raise ValueError(f"sw_extend kernel: {name} must be int64[J] "
                             "on the jobs' device")
    out = torch.empty((6, J), dtype=_I32, device=dev)
    lib = kernels.load("sw_extend")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        ev = kernels.event_pair("sw_extend", stream)
        rc = lib.fgdp_sw_extend(
            query.data_ptr(), target.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), h0.data_ptr(), J, QP, TP, int(w),
            p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop, p.end_bonus,
            p.mat_max, p.mat_mis, p.mat_amb, out.data_ptr(),
            cells.data_ptr() if cells is not None else None,
            rows.data_ptr() if rows is not None else None,
            *kernels.event_ptrs(ev),
            stream.cuda_stream)
    kernels.check(rc, "sw_extend")
    kernels.tally(kernels.LAUNCHES, "sw_extend")
    return SWResult(*out.unbind(0))


def sw_extend_plain(query, qlen, target, tlen, h0, w: int,
                    p: SWParams) -> SWResult:
    """The plain version: one step of torch ops per target row over all
    lanes (ops/sw.sw_extend of the JAX package, transcribed)."""
    B, QP = query.shape
    TP = target.shape[1]
    dev = query.device
    oe_del = p.o_del + p.e_del
    oe_ins = p.o_ins + p.e_ins
    jr = torch.arange(QP + 2, dtype=_I32, device=dev)[None, :]
    jq = torch.arange(QP, dtype=_I32, device=dev)[None, :]

    qlen = qlen.to(_I32)
    tlen = tlen.to(_I32)
    h0 = h0.to(_I32)

    # per-lane band clamp (scalarBandedSWA:146-157); // floors
    max_ins = (qlen * p.mat_max + p.end_bonus - p.o_ins) // p.e_ins + 1
    max_del = (qlen * p.mat_max + p.end_bonus - p.o_del) // p.e_del + 1
    weff = torch.clamp(torch.minimum(max_ins, max_del), min=1) \
        .clamp(max=int(w))

    ramp = h0[:, None] - oe_ins - (jr - 1) * p.e_ins
    eh_h = torch.where(jr == 0, h0[:, None],
                       torch.where(jr <= qlen[:, None], ramp.clamp(min=0),
                                   0)).to(_I32)
    eh_e = torch.zeros((B, QP + 2), dtype=_I32, device=dev)
    qcl = query.clamp(0, 4).to(_I32)

    beg_s = torch.zeros(B, dtype=_I32, device=dev)
    end_s = qlen.clone()
    mx = h0.clone()
    max_i = torch.full((B,), -1, dtype=_I32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros(B, dtype=_I32, device=dev)
    dead = (qlen <= 0) | (tlen <= 0)
    zcol = torch.zeros((B, 1), dtype=_I32, device=dev)

    for i in range(TP):
        active = ~dead & (i < tlen)
        if not bool(active.any()):
            break
        beg = torch.maximum(beg_s, i - weff)
        end = torch.minimum(torch.minimum(end_s, i + weff + 1), qlen)
        h1_init = torch.where(
            beg == 0, (h0 - (p.o_del + p.e_del * (i + 1))).clamp(min=0), 0)

        tb = target[:, i:i + 1].to(_I32)
        q = torch.where((tb >= 4) | (qcl >= 4), p.mat_amb,
                        torch.where(qcl == tb, p.mat_max, -p.mat_mis))

        in_band = (jq >= beg[:, None]) & (jq < end[:, None])
        Hprev = eh_h[:, :QP]
        E = eh_e[:, :QP]
        M = torch.where(Hprev != 0, Hprev + q, 0)
        # F scan: f[beg]=0; f[j] = max_{k<j}(t_k - (j-1-k)e_ins), t>=0
        t_ins = torch.where(in_band, (M - oe_ins).clamp(min=0), NEG_INF)
        v = t_ins + jq * p.e_ins
        cm = torch.cummax(v, dim=1).values
        cm_shift = torch.cat([torch.full((B, 1), NEG_INF, dtype=_I32,
                                         device=dev), cm[:, :-1]], dim=1)
        F = (cm_shift - (jq - 1) * p.e_ins).clamp(min=0)
        H = torch.maximum(torch.maximum(M, E), F)
        H = torch.where(in_band, H, 0).to(_I32)

        # row max: last argmax (mj = m > h ? mj : j)
        mrow = H.amax(dim=1)
        is_max = in_band & (H == mrow[:, None]) & (mrow[:, None] > 0)
        mj = torch.where(is_max, jq, -1).amax(dim=1)

        # eh updates: eh_h[j] = H(i, j-1) for j in (beg, end];
        # eh_h[beg] = h1_init
        Hsh = torch.cat([zcol, H, zcol], dim=1)
        wr_h = (jr > beg[:, None]) & (jr <= end[:, None])
        new_h = torch.where(wr_h, Hsh, eh_h)
        new_h = torch.where(jr == beg[:, None], h1_init[:, None], new_h)
        Epad = torch.cat(
            [torch.where(in_band, torch.maximum((M - oe_del).clamp(min=0),
                                                E - p.e_del), 0),
             zcol, zcol], dim=1)
        wr_e = (jr >= beg[:, None]) & (jr < end[:, None])
        new_e = torch.where(wr_e, Epad, eh_e)
        new_e = torch.where(jr == end[:, None], 0, new_e)
        h1_last = torch.where(
            end > beg, Hsh.gather(1, end.clamp(min=0).long()[:, None])[:, 0],
            h1_init)

        upd = active
        eh_h = torch.where(upd[:, None], new_h, eh_h).to(_I32)
        eh_e = torch.where(upd[:, None], new_e, eh_e).to(_I32)

        at_qend = upd & (end == qlen)
        # ties move max_ie forward (max_ie = gscore > h1 ? max_ie : i)
        max_ie = torch.where(at_qend & (h1_last >= gscore), i, max_ie)
        gscore = torch.where(at_qend & (h1_last > gscore), h1_last, gscore)

        died_zero = upd & (mrow == 0)
        still = upd & ~died_zero
        improved = still & (mrow > mx)
        # z-drop (scalarBandedSWA:215-221), from the state before update
        di = i - max_i
        dj = mj - max_j
        ddiag = torch.where(di > dj, di - dj, dj - di)
        epen = torch.where(di > dj, p.e_del, p.e_ins)
        zdie = still & ~improved & (p.zdrop > 0) & \
            (mx - mrow - ddiag * epen > p.zdrop)
        max_off = torch.where(improved,
                              torch.maximum(max_off, (mj - i).abs()),
                              max_off)
        mx = torch.where(improved, mrow, mx)
        max_i = torch.where(improved, i, max_i).to(_I32)
        max_j = torch.where(improved, mj, max_j)
        alive = still & ~zdie

        # band narrowing over the updated eh arrays
        nz = (eh_h != 0) | (eh_e != 0)
        cand_b = nz & (jr >= beg[:, None]) & (jr < end[:, None])
        nbeg = torch.where(cand_b, jr, end[:, None]).amin(dim=1)
        cand_e = nz & (jr >= nbeg[:, None]) & (jr <= end[:, None])
        last_nz = torch.where(cand_e, jr, nbeg[:, None] - 1).amax(dim=1)
        nend = torch.minimum(last_nz + 2, qlen)

        beg_s = torch.where(alive, nbeg, beg).to(_I32)
        end_s = torch.where(alive, nend, end).to(_I32)
        max_ie = max_ie.to(_I32)
        dead = dead | died_zero | zdie
    return SWResult(score=mx.to(_I32), qle=(max_j + 1).to(_I32),
                    tle=(max_i + 1).to(_I32), gtle=(max_ie + 1).to(_I32),
                    gscore=gscore.to(_I32), max_off=max_off.to(_I32))
