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
// JAX loop's inactive rows give. The arithmetic is int32 and exact: the
// paths fuse adds into max-adds and take maxima in other orders, which
// give the same values.
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
// - kswv_job_regs<K>, QP <= 32 KSWV_MAX_K: an anti-diagonal wavefront
//   across the lanes. Lane l holds query columns l K .. l K + K - 1 of
//   H, E and the best row in registers (K = ceil(QP / 32)) and at step i
//   computes row i - l. What a lane needs from the columns to its left
//   comes from lane l - 1's previous step, one __shfl_up_sync each: the
//   diagonal H (lane l - 1's last column one row up), the running max of
//   v (F's carry) and the row max so far; the target code (as its score
//   selector) comes the same way a step ahead. The row max of row r is
//   complete in lane 31 at the end of step r + 31; at step r + 32 one
//   broadcast from lane 31 gives every lane the row max, the strict
//   improvement test (best and te) and the row max's slot in the buffer
//   stored 32 rows at a time. A lane keeps its last 32 rows of H in a ring
//   indexed by step (`ring`, 32 x K x 32 ints a job: shared memory on the
//   card, a host array in the twin; lane l's row r in slot (r + l) % 32);
//   when row r improves the best, each lane copies its row r into its
//   best-row registers before the step's own row overwrites lane 0's
//   slot. A job runs min(tlen, TP) + 31 steps in chunks of 32: the first
//   chunk keeps the lanes above the wavefront's edge at H = E = 0 (a
//   select) and decides no row, the last 31 steps drain the wavefront
//   (rows past min(tlen, TP) are computed and never read), and the last
//   row is decided after the loop.
//   A cell is the recurrence above with Hopper's DPX max-add instructions
//   (max(a + b, c), max(a + b, c, 0) and max(a, b, c) in one) and the
//   score a byte permute of the column's score profile: four signed bytes,
//   the score against target codes 0..3 (a, -b, or -1 against a query N),
//   0xFF (-1) against a target N. So the path takes a and -b in a signed
//   byte; the C entry point sends other scores to the wide path. The
//   in-row F is the same exclusive prefix max, carried from lane to lane:
//   F's running max before column k is max(the carry, v_0 .. v_k-1), v =
//   G - oe_ins + j e_ins, G = max(M, E, 0), and h = max(F, G): the same
//   values as the row loop's. The carry and column 0's diagonal are the
//   only inputs that wait for a shuffle: columns 1 .. K - 1 take G and the
//   running max of their v from the lane's old row, and the carry enters
//   by one 3-way max a column. Columns at or past qlen (h capped to 0, E
//   then 0) feed only later such columns and the row max through h, so
//   their score need not be NEG.
// - kswv_job_wide, any QP: the row's H and E in the job's scratch
//   (global memory), 'width' columns at a time, one a lane, the F carry
//   and the left neighbour carried from chunk to chunk; the best row is
//   copied from the scratch row when a row improves the best.
#pragma once

#include "common.cuh"

#define KSWV_NEG (-(1 << 30))
// widest register path: K <= KSWV_MAX_K columns a lane, QP <= 32 K
#define KSWV_MAX_K 8
// rows of H a lane keeps for the best row: the wavefront's depth
#define KSWV_RING 32

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

template <class L>
FGDP_HD typename L::I kswv_min(const L& lanes, const typename L::I& x,
                               const typename L::I& y) {
  return lanes.sel(y < x, y, x);
}

FGDP_HD int kswv_clip(int c) { return fgdp_min(fgdp_max(c, 0), 4); }

// max(a + b, c): one DPX instruction on sm_90 (the host twin's Lane32
// overloads act lane by lane)
FGDP_HD int kswv_addmax(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32(a, b, c);
#else
  return fgdp_max(a + b, c);
#endif
}

// max(a + b, c, 0)
FGDP_HD int kswv_addmax0(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32_relu(a, b, c);
#else
  return fgdp_max(fgdp_max(a + b, c), 0);
#endif
}

// the score of a column against target code tc (0..4) from its profile
// `prof` and the step's selector kswv_selector(tc): byte tc of prof
// sign-extended, -1 for tc 4 (prmt's sign-replicating byte select, the
// second source all ones)
FGDP_HD int kswv_score(int prof, int sel) {
#ifdef __CUDA_ARCH__
  int d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(prof), "r"(-1), "r"(sel));
  return d;
#else
  const int c = sel & 7;
  return c < 4 ? (int)(signed char)(unsigned char)((unsigned)prof >> (8 * c))
               : -1;
#endif
}

// prmt selector of byte tc, sign-replicated into the three upper bytes
template <class I>
FGDP_HD I kswv_selector(const I& tc) {
  return tc * 0x1111 + 0x8880;
}

// the profile of query code c (0..3): byte u the score against target
// code u (a, or -b); a query N's profile is -1 (every byte -1)
FGDP_HD int kswv_profile(int c, const KswvParams& p) {
  unsigned w = 0;
  for (int u = 0; u < 4; ++u)
    w |= (unsigned)((u == c ? p.a : -p.b) & 0xFF) << (8 * u);
  return (int)w;
}

// the register path takes the match and mismatch scores as bytes
FGDP_HD bool kswv_bytes_ok(const KswvParams& p) {
  return p.a >= -128 && p.a <= 127 && p.b >= -127 && p.b <= 128;
}

// max(a, b, c): one DPX instruction on sm_90
FGDP_HD int kswv_max3(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax3_s32(a, b, c);
#else
  return fgdp_max(fgdp_max(a, b), c);
#endif
}

// the score selectors of t[from + lane] clipped to 0..4 (4 past the
// rows)
template <class L>
FGDP_HD typename L::I kswv_codes(const L& lanes, const int* t, int T,
                                 int from) {
  using I = typename L::I;
  const I lane = lanes.lane();
  I c = lanes.load(t, lane + from, (lane + from) < T, 4);
  c = kswv_max(lanes, c, I(0));
  return kswv_selector(lanes.sel(I(4) < c, I(4), c));
}

// One step of the wavefront: lane l computes row i - l, i = c0 + u (c0
// a multiple of 32, the step's chunk). On entry tc is the lane's code
// for the row and dg, R and hm what the lane left at its previous step;
// the lane takes lane l - 1's (lane 0: 0, NEG and 0) by one shuffle
// each: the diagonal H (lane l - 1's last column one row up), F's carry
// (the running max of v) and the row max so far. The next step's code
// (its score selector, tc) comes the same way a step ahead (lane 0's,
// t[i + 1]'s, from the chunk's `tq`, t[c0 + 1 + lane]'s), so the score
// waits for no shuffle.
// Columns 1 .. K - 1 take their diagonal from the lane's own old row,
// so their G and the running max of their v (Pv) wait for no shuffle
// either; the shuffled carry enters each column's F by one 3-way max.
// On exit the lane leaves its last column's old H (dg), its running max
// (R) and its row max (hm); its new row in H goes to ring slot u (the
// ring is indexed by step: lane l's row r sits in slot (r + l) % 32).
// DECIDE: row i - 32, complete in lane 31 at the end of the previous
// step, is decided (its max broadcast from lane 31: the row max's buffer
// slot u, the strict improvement test, the best row copied from each
// lane's ring) before this step's row enters the ring, whose slot u held
// lane 0's copy of it. EDGE: lanes not yet at row 0 keep H = E = 0.
template <int K, bool EDGE, bool DECIDE, class L>
FGDP_HD void kswv_wave_step(const L& lanes, int c0, int u,
                            const KswvParams& p, typename L::I* H,
                            typename L::I* E, typename L::I* br,
                            const typename L::I* prof,
                            const typename L::I* cj,
                            const typename L::I* dj,
                            const typename L::I* cap, int* ring,
                            const typename L::I& tq, typename L::I& tc,
                            typename L::I& dg, typename L::I& R,
                            typename L::I& hm, typename L::I& rmbuf,
                            int& best, int& te) {
  using I = typename L::I;
  const I lane = lanes.lane();
  const auto first = lane == 0;
  const int oe_del = p.o_del + p.e_del;
  // row i - 32's max, complete in lane 31 (used below)
  const int rm = DECIDE ? lanes.shfl(hm, 31) : 0;
  const int t0 = lanes.shfl(tq, u);   // t[i + 1]
  const I tc_next = lanes.sel(first, I(t0), lanes.shfl_up(tc, 1));
  const I left = lanes.sel(first, I(0), lanes.shfl_up(dg, 1));
  const I carry = lanes.sel(first, I(KSWV_NEG), lanes.shfl_up(R, 1));
  const I hm_in = lanes.sel(first, I(0), lanes.shfl_up(hm, 1));
  const I sel = tc;
  I G[K], Pv[K + 1];
#pragma unroll
  for (int k = 1; k < K; ++k)
    G[k] = kswv_addmax0(H[k - 1], kswv_score(prof[k], sel), E[k]);
  // Pv[k] = max(v_1 .. v_k-1), v = G - oe_ins + j e_ins
#pragma unroll
  for (int k = 2; k <= K; ++k)
    Pv[k] = k == 2 ? G[1] + cj[1] : kswv_addmax(G[k - 1], cj[k - 1], Pv[k - 1]);
  G[0] = kswv_addmax0(left, kswv_score(prof[0], sel), E[0]);
  const I v0 = G[0] + cj[0];
  const auto act = lane <= c0 + u;
  dg = H[K - 1];
  I loc = I(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // F's running max before column k: the carry, v_0, v_1 .. v_k-1
    const I Rk = k == 0 ? carry
                 : (k == 1 ? kswv_max(lanes, carry, v0)
                           : kswv_max3(carry, v0, Pv[k]));
    I h = kswv_addmax(Rk, dj[k], G[k]);     // max(F, G)
    h = kswv_min(lanes, h, cap[k]);         // 0 at and past qlen
    const I e = kswv_addmax0(E[k], I(-p.e_del), h - oe_del);
    loc = k == 0 ? h : kswv_max(lanes, loc, h);
    if (EDGE) {
      H[k] = lanes.sel(act, h, H[k]);
      E[k] = lanes.sel(act, e, E[k]);
    } else {
      H[k] = h;
      E[k] = e;
    }
  }
  R = K == 1 ? kswv_max(lanes, carry, v0) : kswv_max3(carry, v0, Pv[K]);
  hm = kswv_max(lanes, hm_in, loc);
  tc = tc_next;
  if (DECIDE) {
    rmbuf = lanes.sel(lane == u, I(rm), rmbuf);
    const bool imp = rm > best;   // the same on every lane
    te = imp ? c0 + u - KSWV_RING : te;
    best = imp ? rm : best;
    if (lanes.any(imp)) {
      const I at = ((lane + u) & (KSWV_RING - 1)) * (K * 32) + lane;
#pragma unroll
      for (int k = 0; k < K; ++k)
        br[k] = lanes.load(ring, at + k * 32, true, 0);
    }
  }
  int* row = ring + u * (K * 32);
#pragma unroll
  for (int k = 0; k < K; ++k) lanes.store_if(row + k * 32, lane, H[k], true);
}

// q: the job's query codes [QP]; t: its target codes [TP]; ring: the
// job's KSWV_RING x K x 32 ints; best_row [QP] and row_max [TP] receive
// the H row at te and every row's max.
template <int K, class L>
FGDP_HD void kswv_job_regs(const int* q, const int* t, int QP, int TP,
                           int qlen, int tlen, const KswvParams& p,
                           const L& lanes, int* ring, int* best_row,
                           int* row_max, int& best_out, int& te_out) {
  using I = typename L::I;
  const int oe_ins = p.o_ins + p.e_ins;
  const I lane = lanes.lane();
  const I j0 = lane * K;   // this lane's first column
  const int qeff = fgdp_min(qlen, QP);
  const int T = fgdp_max(fgdp_min(tlen, TP), 0);
  I H[K], E[K], br[K], prof[K], cj[K], dj[K], cap[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const I j = j0 + k;
    I qc = lanes.load(q, j, j < QP, 4);
    qc = kswv_max(lanes, qc, I(0));
    qc = lanes.sel(I(4) < qc, I(4), qc);
    prof[k] = lanes.sel(
        qc == 0, I(kswv_profile(0, p)),
        lanes.sel(qc == 1, I(kswv_profile(1, p)),
                  lanes.sel(qc == 2, I(kswv_profile(2, p)),
                            lanes.sel(qc == 3, I(kswv_profile(3, p)),
                                      I(-1)))));
    cj[k] = j * p.e_ins - oe_ins;
    dj[k] = I(0) - (j - 1) * p.e_ins;
    cap[k] = lanes.sel(j < qeff, I(0x7fffffff), I(0));
    H[k] = I(0);
    E[k] = I(0);
    br[k] = I(0);
  }
  int best = 0, te = -1;
  // T + 31 steps in chunks of 32; row r is decided at step r + 32, the
  // last one after the loop. Lane 0's codes t[c0 + 1 + lane] a chunk,
  // as score selectors, the next chunk's loaded a chunk ahead.
  const int steps = T > 0 ? T + KSWV_RING - 1 : 0;
  I tq = kswv_codes(lanes, t, T, 1);
  I tahead = kswv_codes(lanes, t, T, KSWV_RING + 1);
  I tc = lanes.sel(lane == 0, I(lanes.shfl(kswv_codes(lanes, t, T, 0), 0)),
                   kswv_selector(I(4)));
  I dg = I(0), R = I(KSWV_NEG), hm = I(0), rmbuf = I(0);
  if (steps > 0) {
#pragma unroll 1
    for (int u = 0; u < KSWV_RING; ++u)
      kswv_wave_step<K, true, false>(lanes, 0, u, p, H, E, br, prof, cj, dj,
                                     cap, ring, tq, tc, dg, R, hm, rmbuf,
                                     best, te);
  }
#pragma unroll 1
  for (int c0 = KSWV_RING; c0 < steps; c0 += KSWV_RING) {
    tq = tahead;
    tahead = kswv_codes(lanes, t, T, c0 + KSWV_RING + 1);
    const int n = fgdp_min(KSWV_RING, steps - c0);
#pragma unroll 1
    for (int u = 0; u < n; ++u)
      kswv_wave_step<K, false, true>(lanes, c0, u, p, H, E, br, prof, cj,
                                     dj, cap, ring, tq, tc, dg, R, hm, rmbuf,
                                     best, te);
    // rows c0 - 32 .. c0 - 1, when all decided
    if (n == KSWV_RING)
      lanes.store_if(row_max, lane + (c0 - KSWV_RING), rmbuf, true);
  }
  if (T > 0) {
    // row T - 1, complete in lane 31 after the last step; its ring slot
    // in lane l is (T - 1 + l) % 32
    const int r = T - 1, r32 = r & 31;
    const int rm = lanes.shfl(hm, 31);
    rmbuf = lanes.sel(lane == r32, I(rm), rmbuf);
    lanes.store_if(row_max, lane + (r - r32), rmbuf, lane <= r32);
    if (rm > best) {
      best = rm;
      te = r;
      const I at = ((lane + r) & (KSWV_RING - 1)) * (K * 32) + lane;
#pragma unroll
      for (int k = 0; k < K; ++k)
        br[k] = lanes.load(ring, at + k * 32, true, 0);
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
