// Batched local Smith-Waterman forward pass (mate rescue) for ONE job:
// the per-warp logic of the kswv kernel (kswv.cu), also built on the
// host by host_twin.cc for the CPU tests.
//
// A transcription of the JAX package's fgdp_tpu/ops/kswv.py _forward,
// row by row as that loop computes a row over all query columns: the
// score against the row's target code (-1 against N, NEG on the columns
// at or past qlen), M = H of the previous row one column to the left
// plus the score, the in-row gap F as the exclusive prefix max of
// v[j] = max(M, E, 0)[j] - oe_ins + j e_ins less (j - 1) e_ins (NEG at
// column 0), H = max(M, E, F, 0) and 0 past qlen, the new E, the row
// max, and the first row that strictly improves the best with its H
// row. Rows run to min(tlen, TP); the later rows' maxima are 0, as the
// JAX loop's inactive rows give. The arithmetic is int32 with the same
// operations in the same order; every reduction is a max, which any
// order of the lanes gives alike.
//
// No intermediate overflows int32. The smallest value is NEG plus a
// non-negative H (M on a column past qlen) or NEG + e_ins (F at column
// 0); every other value is at least minus a penalty. The largest is v,
// at most a QP + QP e_ins. So the range holds while QP (a + e_ins) stays
// below 2^30: for mates under 2^20 bases at match scores and extension
// penalties under 2^9, far beyond the CLI's defaults (1 and 1) and its
// read-type profiles.
//
// Two layouts of the same logic:
//
// - kswv_job_regs<K>, QP <= 32 KSWV_MAX_K: lane l holds query columns
//   l K .. l K + K - 1 of H, E, the best row and the query codes in
//   registers (K = ceil(QP / 32)). F is an in-lane running max plus a
//   5-step shuffle-up scan of the lane totals, the row max a warp max,
//   the left neighbour of the lane's first column one shuffle. The
//   target is read 32 codes at a time, one a lane, and broadcast row by
//   row; the row maxima are kept one a lane and stored 32 rows at a time.
// - kswv_job_wide, any QP: the row's H and E in the job's scratch
//   (global memory), 'width' columns at a time, one a lane, the F carry
//   and the left neighbour carried from chunk to chunk; the best row is
//   copied from the scratch row when a row improves the best.
#pragma once

#include "common.cuh"

#define KSWV_NEG (-(1 << 30))
// widest register path: K <= KSWV_MAX_K columns a lane, QP <= 32 K
#define KSWV_MAX_K 8

struct KswvParams {
  int a, b, o_del, e_del, o_ins, e_ins;
};

// max of two lane values (an int on the card, 32 of them in the host
// twin's lockstep warp)
template <class L>
FGDP_HD typename L::I kswv_max(const L& lanes, const typename L::I& x,
                               const typename L::I& y) {
  return lanes.sel(x < y, y, x);
}

FGDP_HD int kswv_clip(int c) { return fgdp_min(fgdp_max(c, 0), 4); }

// q: the job's query codes [QP]; t: its target codes [TP]; best_row
// [QP] and row_max [TP] receive the H row at te and every row's max.
template <int K, class L>
FGDP_HD void kswv_job_regs(const int* q, const int* t, int QP, int TP,
                           int qlen, int tlen, const KswvParams& p,
                           const L& lanes, int* best_row, int* row_max,
                           int& best_out, int& te_out) {
  using I = typename L::I;
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  const I lane = lanes.lane();
  const I j0 = lane * K;   // this lane's first column
  const int qeff = fgdp_min(qlen, QP);
  const int T = fgdp_max(fgdp_min(tlen, TP), 0);
  I H[K], E[K], qc[K], br[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const I j = j0 + k;
    qc[k] = lanes.load(q, j, j < QP, 4);
    qc[k] = kswv_max(lanes, qc[k], I(0));
    qc[k] = lanes.sel(I(4) < qc[k], I(4), qc[k]);
    H[k] = I(0);
    E[k] = I(0);
    br[k] = I(0);
  }
  int best = 0, te = -1;
  I tcache = I(0), rmbuf = I(0);
  for (int i = 0; i < T; ++i) {
    const int r = i % 32;
    if (r == 0) tcache = lanes.load(t, lane + i, (lane + i) < T, 0);
    const int tc = kswv_clip(lanes.shfl(tcache, r));
    const bool tn = tc >= 4;
    // H of the previous row one column to the left (0 left of column 0)
    I left = lanes.shfl_up(H[K - 1], 1);
    left = lanes.sel(lane == 0, I(0), left);
    // M per column, and v's prefix max over the lane's columns before k
    I M[K], pre[K];
    I run = I(KSWV_NEG);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const I j = j0 + k;
      I s = lanes.sel(qc[k] == tc, I(p.a), I(-p.b));
      s = lanes.sel((qc[k] >= 4) | tn, I(-1), s);
      s = lanes.sel(j < qeff, s, I(KSWV_NEG));
      M[k] = (k == 0 ? left : H[k == 0 ? 0 : k - 1]) + s;
      const I G = kswv_max(lanes, kswv_max(lanes, M[k], E[k]), I(0));
      const I v = (G - oe_ins) + j * p.e_ins;
      pre[k] = run;
      run = kswv_max(lanes, run, v);
    }
    // inclusive scan of the lane totals (a lane below d keeps its own)
    I scan = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      scan = kswv_max(lanes, scan, lanes.shfl_up(scan, d));
    I carry = lanes.shfl_up(scan, 1);
    carry = lanes.sel(lane == 0, I(KSWV_NEG), carry);
    I hmax = I(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const I j = j0 + k;
      const I F = kswv_max(lanes, carry, pre[k]) - (j - 1) * p.e_ins;
      I h = kswv_max(lanes, kswv_max(lanes, M[k], E[k]),
                     kswv_max(lanes, F, I(0)));
      h = lanes.sel(j < qeff, h, I(0));
      E[k] = kswv_max(lanes, kswv_max(lanes, E[k] - p.e_del, h - oe_del),
                      I(0));
      H[k] = h;
      hmax = kswv_max(lanes, hmax, h);
    }
    const int rm = lanes.max(hmax);
    rmbuf = lanes.sel(lane == r, I(rm), rmbuf);
    if (r == 31 || i == T - 1)
      lanes.store_if(row_max, lane + (i - r), rmbuf, lane <= r);
    if (rm > best) {   // the same on every lane
      best = rm;
      te = i;
#pragma unroll
      for (int k = 0; k < K; ++k) br[k] = H[k];
    }
  }
  for (int r0 = T; r0 < TP; r0 += 32)
    lanes.store_if(row_max, lane + r0, I(0), (lane + r0) < TP);
#pragma unroll
  for (int k = 0; k < K; ++k)
    lanes.store_if(best_row, j0 + k, br[k], (j0 + k) < QP);
  best_out = best;
  te_out = te;
}

// The same job for any QP: hs and es are the job's scratch rows [QP]
// (H and E of the row), written before they are read.
template <class L>
FGDP_HD void kswv_job_wide(const int* q, const int* t, int QP, int TP,
                           int qlen, int tlen, const KswvParams& p,
                           const L& lanes, int* hs, int* es, int* best_row,
                           int* row_max, int& best_out, int& te_out) {
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  const int lane = lanes.lane(), W = lanes.width();
  const int qeff = fgdp_min(qlen, QP);
  const int T = fgdp_max(fgdp_min(tlen, TP), 0);
  for (int j = lane; j < QP; j += W) {
    hs[j] = 0;
    es[j] = 0;
    best_row[j] = 0;
  }
  int best = 0, te = -1, tcache = 0;
  for (int i = 0; i < T; ++i) {
    if (i % W == 0) tcache = i + lane < T ? t[i + lane] : 0;
    const int tc = kswv_clip(lanes.shfl(tcache, i % W));
    int left = 0, carry = KSWV_NEG, hmax = 0;
    for (int c0 = 0; c0 < QP; c0 += W) {
      const int j = c0 + lane;
      const bool ok = j < QP;
      const int hold = ok ? hs[j] : 0;
      const int e = ok ? es[j] : 0;
      const int qc = ok ? kswv_clip(q[j]) : 4;
      const int up = lanes.shfl_up(hold, 1);
      const int hprev = lane == 0 ? left : up;
      left = lanes.shfl(hold, W - 1);
      int s = qc == tc ? p.a : -p.b;
      s = (qc >= 4 || tc >= 4) ? -1 : s;
      s = j < qeff ? s : KSWV_NEG;
      const int m = hprev + s;
      const int v = (fgdp_max(fgdp_max(m, e), 0) - oe_ins) + j * p.e_ins;
      int scan = v;
      for (int d = 1; d < W; d <<= 1)
        scan = fgdp_max(scan, lanes.shfl_up(scan, d));
      int ex = lanes.shfl_up(scan, 1);
      if (lane == 0) ex = KSWV_NEG;
      const int f = fgdp_max(carry, ex) - (j - 1) * p.e_ins;
      carry = fgdp_max(carry, lanes.shfl(scan, W - 1));
      int h = fgdp_max(fgdp_max(m, e), fgdp_max(f, 0));
      h = j < qeff ? h : 0;
      if (ok) {
        hs[j] = h;
        es[j] = fgdp_max(fgdp_max(e - p.e_del, h - oe_del), 0);
      }
      hmax = fgdp_max(hmax, h);
    }
    const int rm = lanes.max(hmax);
    if (lane == 0) row_max[i] = rm;
    if (rm > best) {   // the same on every lane
      best = rm;
      te = i;
      for (int j = lane; j < QP; j += W) best_row[j] = hs[j];
    }
  }
  for (int i = T + lane; i < TP; i += W) row_max[i] = 0;
  best_out = best;
  te_out = te;
}
