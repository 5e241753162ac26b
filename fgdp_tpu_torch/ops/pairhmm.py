"""Batched PairHMM forward likelihoods: kernel wrapper + plain version.

The reference computes striped-AVX forward DP per (read, haplotype) pair
(deepmutect .../intel/pairhmm/avx-pairhmm-template.h:204,475;
IntelPairHmm.cc). On the card the hand-written kernel csrc/pairhmm.cu
runs the float32 pass, one warp per pair with the pair's DP row in
registers, or in shared memory for H above 639 (it replaces the TPU
kernel fgdp_tpu/ops/pairhmm_pallas.py). `forward_f32` beside it is
the same function as a row loop of torch ops, transcribed from the JAX
package's ops/pairhmm._forward: the CPU path and the tests run it, and
the card's smoke run holds the kernel against it.

`forward_f32_any` takes the kernel for CUDA tensors and the plain version
for CPU tensors, and nothing else: a failing launch raises.

Numerics follow GKL: float32 with INITIAL_CONSTANT 2^120 and a float64
(2^1020) second pass on the host for pairs whose result falls below
MIN_ACCEPTED (Context.h:183-189, pairhmm_common.h:41,
IntelPairHmm.cc:340-349). Transition probabilities (including the
Jacobian-table matchToMatch blend) are precomputed exactly on the host:
see `transitions`. The in-row deletion recurrence
Y[i,j] = M[i,j-1]*tMY + Y[i,j-1]*tYY is computed by log-doubling, in the
same order of operations as the JAX package, so that the f32 roundings
agree.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.profiling import HMM_F64, HMM_WAIT, PROF
from . import kernels

LOG10_IC_F32 = 120 * np.log10(2.0)
LOG10_IC_F64 = 1020 * np.log10(2.0)
MIN_ACCEPTED = 1e-28           # pairhmm_common.h:41
MAX_QUAL = 254

# match-state transition indices in the trans array
MM, GM, MX, XX, MY, YY = range(6)

_F32 = torch.float32
_I32 = torch.int32

# the kernel's two paths, as its C entry point reports the one it took
# (chosen from H alone, before the launch): the pair's DP row in
# registers, or in shared memory for haplotypes wider than the kernel
# library's fgdp_pairhmm_reg_max_h(); launches of each
KERNEL_PATHS = ("registers", "wide")
PATH_LAUNCHES = {p: 0 for p in KERNEL_PATHS}


@functools.lru_cache()
def _match_to_match_prob() -> np.ndarray:
    """Exact port of Context initializeMatchToMatchProb (Context.h:76-92):
    matchToMatch[i, j] for maxQual i, minQual j via the Jacobian table."""
    step = 0.0001
    k = np.arange(int(8.0 / step) + 1)
    jacobian = np.log10(1.0 + 10.0 ** (-k * step))
    out = np.zeros(((MAX_QUAL + 1) * (MAX_QUAL + 2)) // 2)
    idx = 0
    for i in range(MAX_QUAL + 1):
        for j in range(i + 1):
            small, big = -0.1 * i, -0.1 * j
            diff = big - small
            if diff >= 8.0:
                log10sum = big
            else:
                ind = int(diff / step + 0.5)
                log10sum = big + jacobian[ind]
            with np.errstate(divide="ignore"):
                m2m = np.log1p(-min(1.0, 10.0 ** log10sum)) * 0.434294
            out[idx] = 10.0 ** m2m
            idx += 1
    return out


def transitions(i_qual, d_qual, c_qual, dtype=np.float32) -> np.ndarray:
    """Per-base transition probs [..., 6] (Context set_mm_prob + ph2pr).
    i/d/c_qual: int arrays (insertion, deletion, gap-continuation quals).
    """
    i_qual = np.asarray(i_qual, np.int64)
    d_qual = np.asarray(d_qual, np.int64)
    c_qual = np.asarray(c_qual, np.int64)
    ph2pr = 10.0 ** (-np.arange(128) / 10.0)
    m2m = _match_to_match_prob()
    mx = np.maximum(i_qual, d_qual)
    mn = np.minimum(i_qual, d_qual)
    mm = m2m[(mx * (mx + 1)) // 2 + mn]
    gapc = ph2pr[np.clip(c_qual, 0, 127)]
    return np.stack([
        mm.astype(dtype),
        (1.0 - gapc).astype(dtype),
        ph2pr[np.clip(i_qual, 0, 127)].astype(dtype),
        gapc.astype(dtype),
        ph2pr[np.clip(d_qual, 0, 127)].astype(dtype),
        gapc.astype(dtype),
    ], axis=-1)


def doubling_cap(c_quals) -> int | None:
    """Largest useful in-row scan depth for the f32 pass, from the
    gap-continuation quals: iteration d of the log-doubling scan
    multiplies by t_yy^(2^d) = 10^(-cq/10 * 2^d); once that is below
    the smallest f32 denormal (~10^-44.85) the multiplier rounds to
    EXACTLY 0.0 and the iteration is a bit-exact no-op. For cq >= 8,
    d = 6 already gives 10^-51.2 -> 0, so 6 doublings (span 64 columns)
    suffice regardless of H. Returns None (no cap) when any cq < 8."""
    cq = np.asarray(c_quals)
    if cq.size and int(cq.min()) >= 8:
        return 6
    return None


def n_doublings(H: int, cap: int | None) -> int:
    """Depth of the in-row log-doubling scan over H haplotype columns."""
    n = max(1, int(np.ceil(np.log2(max(H, 2)))))
    return n if cap is None else min(n, cap)


def _log10_scaled(acc):
    return torch.log10(torch.clamp(acc, min=torch.finfo(_F32).tiny)) \
        - torch.tensor(LOG10_IC_F32, dtype=_F32, device=acc.device)


def forward_f32_any(reads, rlens, pq, trans, haps, hlens,
                    n_doubling_cap=None):
    """The float32 pass on the inputs' device: the kernel for CUDA
    tensors, the plain version for CPU tensors. Returns
    (log10_lik f32[NP], raw_sum f32[NP])."""
    if reads.is_cuda:
        return forward_f32_kernel(reads, rlens, pq, trans, haps, hlens,
                                  n_doubling_cap=n_doubling_cap)
    return forward_f32(reads, rlens, pq, trans, haps, hlens,
                       n_doubling_cap=n_doubling_cap)


def forward_f32_kernel(reads, rlens, pq, trans, haps, hlens,
                       n_doubling_cap=None):
    """Launch csrc/pairhmm.cu on CUDA tensors. reads int32[NP, R],
    pq f32[NP, R], trans f32[NP, R, 6], haps int32[NP, H],
    rlens/hlens int32[NP]. Returns (log10_lik, raw_sum) as
    `forward_f32` does."""
    NP, R = reads.shape
    H = haps.shape[1]
    dev = reads.device
    args = dict(reads=(reads, _I32), rlens=(rlens, _I32), pq=(pq, _F32),
                trans=(trans, _F32), haps=(haps, _I32),
                hlens=(hlens, _I32))
    conv = {}
    for name, (a, dt) in args.items():
        if not a.is_cuda or a.device != dev:
            raise ValueError(f"pairhmm kernel: {name} is not on {dev}")
        if a.shape[0] != NP:
            raise ValueError(f"pairhmm kernel: {name} has {a.shape[0]} "
                             f"rows, expected {NP}")
        conv[name] = a.to(dt).contiguous()
    if pq.shape != (NP, R) or trans.shape != (NP, R, 6) or \
            rlens.dim() != 1 or hlens.dim() != 1:
        raise ValueError("pairhmm kernel: pq must be [NP, R], trans "
                         "[NP, R, 6], rlens/hlens 1-D")
    # the kernel reads each pair's rows up to rlen and columns up to hlen
    if NP and (int(conv["rlens"].max()) > R or int(conv["hlens"].max()) > H
               or int(conv["rlens"].min()) < 0
               or int(conv["hlens"].min()) < 0):
        raise ValueError(f"pairhmm kernel: rlens/hlens outside [0, {R}] / "
                         f"[0, {H}]")
    acc = torch.empty(NP, dtype=_F32, device=dev)
    lib = kernels.load("pairhmm")
    path = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        ev = kernels.event_pair("pairhmm", stream)
        rc = lib.fgdp_pairhmm_f32(
            conv["reads"].data_ptr(), conv["pq"].data_ptr(),
            conv["trans"].data_ptr(), conv["haps"].data_ptr(),
            conv["rlens"].data_ptr(), conv["hlens"].data_ptr(), NP, R, H,
            n_doublings(H, n_doubling_cap), acc.data_ptr(),
            ctypes.addressof(path),
            *kernels.event_ptrs(ev),
            stream.cuda_stream)
    kernels.check(rc, "pairhmm")
    kernels.tally(kernels.LAUNCHES, "pairhmm")
    kernels.tally(PATH_LAUNCHES, KERNEL_PATHS[path.value])
    return _log10_scaled(acc), acc


def forward_f32(reads, rlens, pq, trans, haps, hlens, n_doubling_cap=None):
    """The plain version: one step of torch ops per read row over all
    pairs and haplotype columns (ops/pairhmm._forward of the JAX package,
    transcribed). Returns (log10_lik f32[NP], raw_sum f32[NP])."""
    NP, R = reads.shape
    H = haps.shape[1]
    dev = reads.device
    reads = reads.to(_I32)
    rlens = rlens.to(_I32)
    hlens = hlens.to(_I32)
    pq = pq.to(_F32)
    trans = trans.to(_F32)
    one = torch.tensor(1.0, dtype=_F32, device=dev)
    three = torch.tensor(3.0, dtype=_F32, device=dev)
    zero = torch.tensor(0.0, dtype=_F32, device=dev)
    init_const = torch.tensor(2.0 ** 120, dtype=_F32, device=dev)

    init_y = init_const / hlens.to(_F32)                   # [NP]
    jcol = torch.arange(H + 1, dtype=_I32, device=dev)[None, :]
    col_valid = (jcol >= 1) & (jcol <= hlens[:, None])
    hap_at = torch.cat([torch.full((NP, 1), 4, dtype=_I32, device=dev),
                        haps.to(_I32)], dim=1)             # [NP, H+1]
    hap_ge4 = hap_at >= 4

    M = torch.zeros((NP, H + 1), dtype=_F32, device=dev)
    X = torch.zeros((NP, H + 1), dtype=_F32, device=dev)
    Y = init_y[:, None].expand(NP, H + 1).clone()
    nd = n_doublings(H, n_doubling_cap)
    zcol = torch.zeros((NP, 1), dtype=_F32, device=dev)

    def shiftk(a, k):
        if k > H:
            return torch.zeros_like(a)
        return torch.cat([zcol.expand(NP, k), a[:, :H + 1 - k]], dim=1)

    r_hi = min(int(rlens.max()) if NP else 0, R)
    for i in range(r_hi):
        rbase = reads[:, i:i + 1]
        pq_i = pq[:, i:i + 1]
        tr = trans[:, i]
        match = (hap_at == rbase) | hap_ge4 | (rbase >= 4)
        prior = torch.where(match, one - pq_i, pq_i / three)
        Mi = prior * (shiftk(M, 1) * tr[:, MM, None] +
                      (shiftk(X, 1) + shiftk(Y, 1)) * tr[:, GM, None])
        Mi = torch.where(jcol >= 1, Mi, zero)
        Xi = M * tr[:, MX, None] + X * tr[:, XX, None]
        Xi = torch.where(jcol >= 1, Xi, zero)
        u = shiftk(Mi, 1) * tr[:, MY, None]
        cp = tr[:, YY, None]
        y = u
        k = 1
        for _ in range(nd):
            y = y + cp * shiftk(y, k)
            cp = cp * cp
            k <<= 1
        Yi = torch.where(jcol >= 1, y, zero)
        live = (i < rlens)[:, None]
        M = torch.where(live, Mi, M)
        X = torch.where(live, Xi, X)
        Y = torch.where(live, Yi, Y)
    # each pair's state froze at its own last row, so one sum after the
    # loop is the sum over that row's columns 1..hlen; it adds in column
    # order, as the kernel does (the JAX package's sum order is XLA's)
    S = torch.where(col_valid, M + X, zero)
    acc = torch.zeros(NP, dtype=_F32, device=dev)
    for j in range(1, H + 1):
        acc = acc + S[:, j]
    return _log10_scaled(acc), acc


def forward_f64(reads, rlens, pq64, trans64, haps, hlens):
    """float64 second pass (GKL double path, IntelPairHmm.cc:340-349) on
    the host, vectorized over pairs and haplotype columns with one
    iteration per read row; the in-row Y recurrence uses the same
    log-doubling form as the f32 pass."""
    reads = np.asarray(reads)
    haps = np.asarray(haps)
    NP, _ = reads.shape
    Hm = haps.shape[1]
    if NP == 0:
        return np.zeros(0)
    rl = np.asarray(rlens, np.int64)
    hl = np.asarray(hlens, np.int64)
    tr = np.asarray(trans64, np.float64)        # [NP, R, 6]
    pq = np.asarray(pq64, np.float64)
    hap_at = np.concatenate(
        [np.full((NP, 1), 4, haps.dtype), haps], axis=1)   # [NP, Hm+1]
    jcol = np.arange(Hm + 1)[None, :]
    col_valid = (jcol >= 1) & (jcol <= hl[:, None])
    hap_ge4 = hap_at >= 4
    M = np.zeros((NP, Hm + 1))
    X = np.zeros((NP, Hm + 1))
    Y = np.broadcast_to((2.0 ** 1020) / hl[:, None],
                        (NP, Hm + 1)).copy()
    n_doubling = n_doublings(Hm, None)

    def shift1(a, k=1):
        out = np.zeros_like(a)
        out[:, k:] = a[:, :-k]
        return out

    for i in range(int(rl.max())):
        rb = reads[:, i][:, None]
        match = (hap_at == rb) | hap_ge4 | (rb >= 4)
        pqi = pq[:, i][:, None]
        prior = np.where(match, 1.0 - pqi, pqi / 3.0)
        t = tr[:, i]
        Mi = prior * (shift1(M) * t[:, MM, None] +
                      (shift1(X) + shift1(Y)) * t[:, GM, None])
        Xi = M * t[:, MX, None] + X * t[:, XX, None]
        u = shift1(Mi) * t[:, MY, None]
        cp = t[:, YY, None].copy()
        y = u
        k = 1
        for _ in range(n_doubling):
            y = y + cp * shift1(y, k)
            cp = cp * cp
            k <<= 1
        live = (i < rl)[:, None]
        M = np.where(live, Mi, M)
        X = np.where(live, Xi, X)
        Y = np.where(live, y, Y)
    acc = np.where(col_valid, M + X, 0.0).sum(axis=1)
    return np.log10(np.maximum(acc, np.finfo(np.float64).tiny)) \
        - LOG10_IC_F64


_PH2PR64 = 10.0 ** (-np.arange(128) / 10.0)
_PH2PR32 = _PH2PR64.astype(np.float32)


def compute_log_likelihoods_async(reads, rlens, quals, i_quals, d_quals,
                                  c_quals, haps, hlens, device):
    """Start the f32 pass on `device` (numpy in) and return a collect()
    thunk that syncs, re-runs in f64 on the host the pairs whose unscaled
    result is below MIN_ACCEPTED, and returns the float64 log10 numpy
    result. Lets callers overlap host work (the next region's assembly)
    with the card's computation."""
    dev = torch.device(device)
    pq32 = _PH2PR32[np.clip(quals, 0, 127)]
    tr32 = transitions(i_quals, d_quals, c_quals, np.float32)
    cap = doubling_cap(c_quals)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(
            dev, non_blocking=True)

    out_d, raw_d = forward_f32_any(
        put(reads, _I32), put(rlens, _I32), put(pq32, _F32),
        put(tr32, _F32), put(haps, _I32), put(hlens, _I32),
        n_doubling_cap=cap)

    def collect():
        with PROF.phase(HMM_WAIT):
            out = out_d.cpu().numpy().astype(np.float64)
            raw = raw_d.cpu().numpy()
        # unscaled result = raw / 2^120; re-run in f64 when < MIN_ACCEPTED
        bad = (raw.astype(np.float64) / (2.0 ** 120)) < MIN_ACCEPTED
        if bad.any():
            idx = np.flatnonzero(bad)
            PROF.count(HMM_F64, len(idx))
            with PROF.phase(HMM_F64):
                pq64 = _PH2PR64[np.clip(quals[idx], 0, 127)]
                tr64 = transitions(i_quals[idx], d_quals[idx],
                                   c_quals[idx], np.float64)
                out[idx] = forward_f64(reads[idx], rlens[idx], pq64, tr64,
                                       haps[idx], hlens[idx])
        return out

    return collect
