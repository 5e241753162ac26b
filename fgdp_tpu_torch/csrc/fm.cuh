// FM-index rank primitives (D1) as device functions, shared by the
// seeding kernels (smem_lcp.cu, k2_lcp.cu, seed_strategy.cu) and built on
// the host by host_twin.cc for the CPU tests. K1 and K2 take them one
// interval a thread; K3 takes forward_extend2's group form, one interval
// a 16-lane group (fm_forward_extend2_group).
//
// A transcription of the port's ops/fm.py (itself the JAX package's
// fgdp_tpu/ops/fm.py :113-322) for ONE interval: _fetch, _fetch_pair,
// occ4, backward_extend2, forward_extend2, init_interval and sa_lookup.
// One fused checkpoint row of 24 int32 a 32-suffix block (cols 0-3 the
// single-character counts, 4-19 the dinucleotide counts, 20-21 the packed
// BWT words B, 22-23 the packed B1 words) answers every rank a one- or
// two-character extension needs: the within-block rank is a masked 2-bit
// compare of the packed words and a __popc of the even-bit mask. Every
// gather index is clamped to its table, as ops/fm.gather_rows does (the
// JAX package's mode="clip"), and the sentinel and the two spurious pair
// codes (cc_r0, cc_r1) are corrected as there. Arithmetic is int32.
#pragma once

#include "common.cuh"

#define FM_EVEN 0x55555555u

// The device FM-index: pointers into the DeviceFMIndex tensors (on the
// card, or host memory for the twin) and its scalars.
struct FmView {
  const int* occ;        // int32[nblocks, 24] fused checkpoint rows
  long long nblocks;
  const int* counts;     // int32[5]  C array (sentinel rank 0)
  const int* c2;         // int32[17] dinucleotide first rows
  const int* sa;         // int32[sa_len]
  long long sa_len;
  int sentinel_row, r1_row, cc_r0, cc_r1;
};

FGDP_HD int fm_clamp3(int c) { return fgdp_min(fgdp_max(c, 0), 3); }

// v[c] with c = 0..3 a run-time character: register selects (an array
// indexed by a run-time value would go to the stack frame)
FGDP_HD int fm_pick4(const int v[4], int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : (c == 2 ? v[2] : v[3]));
}

FGDP_HD long long fm_clampll(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

FGDP_HD int fm_popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// even-bit mask of the codes == c in a packed word of 16 2-bit codes
FGDP_HD unsigned fm_sel(unsigned word, int c) {
  const unsigned b0 = word & FM_EVEN, b1 = (word >> 1) & FM_EVEN;
  const unsigned m0 = (c & 1) ? b0 : ~b0;
  const unsigned m1 = (c & 2) ? b1 : ~b1;
  return m0 & m1 & FM_EVEN;
}

// code slots below `bits` (0..16) of a word
FGDP_HD unsigned fm_prefix(int bits) {
  return bits >= 16 ? 0xFFFFFFFFu : ((1u << (2 * bits)) - 1u);
}

// row of position i, clamped to the table; its in-block prefix masks
FGDP_HD const int* fm_row(const FmView& fm, int i, unsigned pm[2]) {
  const int rem = i & 31;
  pm[0] = fm_prefix(fgdp_min(rem, 16));
  pm[1] = fm_prefix(fgdp_max(rem - 16, 0));
  return fm.occ + fm_clampll((long long)(i >> 5), fm.nblocks - 1) * 24;
}

// A decoded row (_RowRanks): occ of the 4 characters (sentinel
// corrected) and occ of the 4 pairs (c1, c2fix), c1 = 0..3.
struct FmRanks {
  int occ1[4];
  int occ2c[4];
  int i;
};

FGDP_HD void fm_fetch(const FmView& fm, int i, int c2fix, FmRanks& o) {
  unsigned pm[2];
  const int* row = fm_row(fm, i, pm);
  int v[24];
  fgdp_ld_row24(row, v);
  unsigned w[4];
  for (int t = 0; t < 4; ++t) w[t] = (unsigned)v[20 + t];
  for (int c = 0; c < 4; ++c)
    o.occ1[c] = v[c] + fm_popc(fm_sel(w[0], c) & pm[0]) +
                fm_popc(fm_sel(w[1], c) & pm[1]);
  if (i > fm.sentinel_row) o.occ1[0] -= 1;
  const int cf = fm_clamp3(c2fix);
  const unsigned mb0 = fm_sel(w[0], cf), mb1 = fm_sel(w[1], cf);
  for (int c1 = 0; c1 < 4; ++c1) {
    const int cc = c1 * 4 + cf;
    const int* row2 = v + 4 + 4 * c1;   // the pairs (c1, 0..3)
    int x = fm_pick4(row2, cf) + fm_popc(mb0 & fm_sel(w[2], c1) & pm[0]) +
            fm_popc(mb1 & fm_sel(w[3], c1) & pm[1]);
    if (cc == fm.cc_r0 && i > fm.sentinel_row) x -= 1;
    if (cc == fm.cc_r1 && i > fm.r1_row) x -= 1;
    o.occ2c[c1] = x;
  }
  o.i = i;
}

// Occ(c, i) of the four bases
FGDP_HD void fm_occ4(const FmView& fm, int i, int out[4]) {
  FmRanks r;
  fm_fetch(fm, i, 0, r);
  for (int c = 0; c < 4; ++c) out[c] = r.occ1[c];
}

// _bwd_from_ranks: backward extension of (k, l, s) by c from the rows at
// k and k + s; returns (new k, new l, new s)
FGDP_HD void fm_bwd_from_ranks(const FmView& fm, const FmRanks& lo,
                               const FmRanks& hi, int l, int c, int& nk,
                               int& nl, int& ns) {
  int sz[4];
  for (int t = 0; t < 4; ++t) sz[t] = hi.occ1[t] - lo.occ1[t];
  const int sent_in =
      (lo.i <= fm.sentinel_row && fm.sentinel_row < hi.i) ? 1 : 0;
  int ls[4];
  ls[3] = l + sent_in;
  ls[2] = ls[3] + sz[3];
  ls[1] = ls[2] + sz[2];
  ls[0] = ls[1] + sz[1];
  const int cc = fm_clamp3(c);
  nk = fgdp_ld(fm.counts + cc) + fm_pick4(lo.occ1, cc);
  nl = fm_pick4(ls, cc);
  ns = fm_pick4(sz, cc);
}

// _fetch_pair, split in two: what a pair rank reads of one row (the
// row, its packed BWT words B and B1, and the counts Occ(c2) and
// Occ2(pair) at the block start), and Occ(c2, i) and Occ2((c1, c2), i)
// from them
struct FmPairRow {
  const int* row;
  int w4[4];
  int n1, n2;
};

FGDP_HD void fm_pair_load(const FmView& fm, int i, int c2, int pair,
                          FmPairRow& o) {
  unsigned pm[2];
  o.row = fm_row(fm, i, pm);
  fgdp_ld4(o.row + 20, o.w4);
  o.n1 = fgdp_ld(o.row + c2);
  o.n2 = fgdp_ld(o.row + 4 + pair);
}

FGDP_HD void fm_pair_rank(const FmView& fm, const FmPairRow& r, int i,
                          int c2, int pair, int& occ1, int& occ2) {
  const int rem = i & 31;
  unsigned pm[2];
  pm[0] = fm_prefix(fgdp_min(rem, 16));
  pm[1] = fm_prefix(fgdp_max(rem - 16, 0));
  const int c1 = pair >> 2;
  int n1 = 0, n2 = 0;
  for (int t = 0; t < 2; ++t) {
    const unsigned mb = fm_sel((unsigned)r.w4[t], c2);
    const unsigned mb1 = fm_sel((unsigned)r.w4[t + 2], c1);
    n1 += fm_popc(mb & pm[t]);
    n2 += fm_popc(mb & mb1 & pm[t]);
  }
  occ1 = r.n1 + n1 - ((c2 == 0 && i > fm.sentinel_row) ? 1 : 0);
  occ2 = r.n2 + n2 - ((pair == fm.cc_r0 && i > fm.sentinel_row) ? 1 : 0) -
         ((pair == fm.cc_r1 && i > fm.r1_row) ? 1 : 0);
}

// Prepend c2, then c1 (pattern P -> c1 c2 P) from the same two rows:
// (k1, s1) after c2, (k2, s2) after c1 c2. C and C2 come from `cnt`
// (int[4]) and `c2t` (int[16]), which K1 keeps in shared memory; an
// interval whose two ends lie in one 32-row block reads that row once.
FGDP_HD void fm_backward_extend2(const FmView& fm, const int* cnt,
                                 const int* c2t, int k, int s, int c2,
                                 int c1, int& k1, int& s1, int& k2,
                                 int& s2) {
  const int cc2 = fm_clamp3(c2), cc1 = fm_clamp3(c1);
  const int pair = cc1 * 4 + cc2;
  FmPairRow lo, hi;
  fm_pair_load(fm, k, cc2, pair, lo);
  unsigned pm[2];
  if (fm_row(fm, k + s, pm) == lo.row)
    hi = lo;
  else
    fm_pair_load(fm, k + s, cc2, pair, hi);
  int o1lo, o2lo, o1hi, o2hi;
  fm_pair_rank(fm, lo, k, cc2, pair, o1lo, o2lo);
  fm_pair_rank(fm, hi, k + s, cc2, pair, o1hi, o2hi);
  k1 = cnt[cc2] + o1lo;
  s1 = o1hi - o1lo;
  k2 = c2t[pair] + o2lo;
  s2 = o2hi - o2lo;
}

// the same with C and C2 from the index's own tables (read-only loads)
// and both rows always read: K2's form (taking K1's, with its generic
// table loads and the shared-row test, made K2 0.42 -> 0.455 ms on an
// H100 80GB HBM3 at 700 W, chip_smoke.py's scale phase)
FGDP_HD void fm_backward_extend2(const FmView& fm, int k, int s, int c2,
                                 int c1, int& k1, int& s1, int& k2,
                                 int& s2) {
  const int cc2 = fm_clamp3(c2), cc1 = fm_clamp3(c1);
  const int pair = cc1 * 4 + cc2;
  FmPairRow lo, hi;
  fm_pair_load(fm, k, cc2, pair, lo);
  fm_pair_load(fm, k + s, cc2, pair, hi);
  int o1lo, o2lo, o1hi, o2hi;
  fm_pair_rank(fm, lo, k, cc2, pair, o1lo, o2lo);
  fm_pair_rank(fm, hi, k + s, cc2, pair, o1hi, o2hi);
  k1 = fgdp_ld(fm.counts + cc2) + o1lo;
  s1 = o1hi - o1lo;
  k2 = fgdp_ld(fm.c2 + pair) + o2lo;
  s2 = o2hi - o2lo;
}

// Append ca, then cb (pattern P -> P ca cb) from the same two rows:
// (k1, l1, s1) after ca, (k2, l2, s2) after ca cb
FGDP_HD void fm_forward_extend2(const FmView& fm, int k, int l, int s,
                                int ca, int cb, int& k1, int& l1, int& s1,
                                int& k2, int& l2, int& s2) {
  const int ca3 = 3 - fm_clamp3(ca), cb3 = 3 - fm_clamp3(cb);
  FmRanks lo, hi;
  fm_fetch(fm, l, ca3, lo);
  fm_fetch(fm, l + s, ca3, hi);
  // intermediate: backward extension on the reverse-complement side
  fm_bwd_from_ranks(fm, lo, hi, k, ca3, l1, k1, s1);
  // final: the 2-step prepend (3-cb)(3-ca) on the reverse-complement side
  const int pair = cb3 * 4 + ca3;
  l2 = fgdp_ld(fm.c2 + pair) + fm_pick4(lo.occ2c, cb3);
  int d[4], sum = 0;
  for (int t = 0; t < 4; ++t) {
    d[t] = hi.occ2c[t] - lo.occ2c[t];
    sum += d[t];
  }
  s2 = fm_pick4(d, cb3);
  // forward sub-partition of [k1, k1 + s1): '$' first, then increasing
  // continuation character (d indexed by 3 - character, cb = 3 - cb3)
  const int before = (cb3 < 3 ? d[3] : 0) + (cb3 < 2 ? d[2] : 0) +
                     (cb3 < 1 ? d[1] : 0);
  k2 = k1 + (s1 - sum) + before;
}

// The group form of forward_extend2 (K3's kernel, seed_strategy.cuh):
// a group of FM_GROUP = 16 lanes computes the 16 ranks one step needs,
// one a lane, from the rows at l (lanes 0-7) and l + s (lanes 8-15):
// lane g's rank is occ1[c] (g & 4 clear) or occ2c[c] (g & 4 set), c =
// g & 3, as fm_fetch(row, cf) gives them. Each lane reads its row's
// packed words (one 16-byte load, the same address across the row's 8
// lanes) and its one count (a 4-byte load): the group's loads of a step
// touch the two rows only. The character selects are register selects.
#define FM_GROUP 16

FGDP_HD int fm_group_rank(const FmView& fm, int i, int g, int cf) {
  unsigned pm[2];
  const int* row = fm_row(fm, i, pm);
  const int c = g & 3;
  const bool pair = (g & 4) != 0;
  int w4[4];
  fgdp_ld4(row + 20, w4);
  const int cnt = fgdp_ld(row + (pair ? 4 + 4 * c + cf : c));
  const int ca = pair ? cf : c;
  const unsigned b0 = pair ? fm_sel((unsigned)w4[2], c) : 0xFFFFFFFFu;
  const unsigned b1 = pair ? fm_sel((unsigned)w4[3], c) : 0xFFFFFFFFu;
  int x = cnt + fm_popc(fm_sel((unsigned)w4[0], ca) & b0 & pm[0]) +
          fm_popc(fm_sel((unsigned)w4[1], ca) & b1 & pm[1]);
  const int cc = c * 4 + cf;
  if (pair ? (cc == fm.cc_r0 && i > fm.sentinel_row)
           : (c == 0 && i > fm.sentinel_row))
    x -= 1;
  if (pair && cc == fm.cc_r1 && i > fm.r1_row) x -= 1;
  return x;
}

// lane g's rank of a forward_extend2 step on (l, s) with character ca
// (a functor: the group policy runs it once a lane)
struct FmGroupRank {
  const FmView& fm;
  int l, s, cf;
  FGDP_HD int operator()(int g) const {
    return fm_group_rank(fm, g < 8 ? l : l + s, g & 7, cf);
  }
};

// fm_forward_extend2 by a group: `grp` runs FmGroupRank on its lanes
// (grp.each) and reads lane t's value (grp.get); every lane ends with
// the same outputs.
template <class Group>
FGDP_HD void fm_forward_extend2_group(const FmView& fm, const Group& grp,
                                      int k, int l, int s, int ca, int cb,
                                      int& k1, int& l1, int& s1, int& k2,
                                      int& l2, int& s2) {
  const int ca3 = 3 - fm_clamp3(ca), cb3 = 3 - fm_clamp3(cb);
  const auto v = grp.each(FmGroupRank{fm, l, s, ca3});
  int lo1[4], lo2[4], sz[4], d[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    lo1[t] = grp.get(v, t);
    lo2[t] = grp.get(v, 4 + t);
    sz[t] = grp.get(v, 8 + t) - lo1[t];
    d[t] = grp.get(v, 12 + t) - lo2[t];
  }
  // backward extension by ca3 on the reverse-complement side
  // (fm_bwd_from_ranks with lo.i = l, hi.i = l + s)
  const int sent_in =
      (l <= fm.sentinel_row && fm.sentinel_row < l + s) ? 1 : 0;
  l1 = fgdp_ld(fm.counts + ca3) + fm_pick4(lo1, ca3);
  k1 = k + sent_in + (ca3 < 3 ? sz[3] : 0) + (ca3 < 2 ? sz[2] : 0) +
       (ca3 < 1 ? sz[1] : 0);
  s1 = fm_pick4(sz, ca3);
  // the 2-step prepend (3-cb)(3-ca); the forward sub-partition of
  // [k1, k1 + s1): d indexed by 3 - character, '$' first
  l2 = fgdp_ld(fm.c2 + cb3 * 4 + ca3) + fm_pick4(lo2, cb3);
  s2 = fm_pick4(d, cb3);
  const int sum = d[0] + d[1] + d[2] + d[3];
  const int before = (cb3 < 3 ? d[3] : 0) + (cb3 < 2 ? d[2] : 0) +
                     (cb3 < 1 ? d[1] : 0);
  k2 = k1 + (s1 - sum) + before;
}

#ifdef __CUDACC__
// The group policy of fm_forward_extend2_group on the card: the 16 lanes
// of a half warp (K3's and D9's kernels add how they stage a read).
struct FmHalfWarp {
  int g;           // lane in the group
  unsigned mask;   // the group's half of the warp
  template <class F>
  __host__ __device__ int each(const F& f) const { return f(g); }
  // v of group lane src, in every lane of the group
  __host__ __device__ int get(int v, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(mask, v, src, FM_GROUP);
#else
    return v;
#endif
  }
  __host__ __device__ bool lead() const { return g == 0; }
};
#endif

// bi-interval of the one-base pattern c
FGDP_HD void fm_init_interval(const FmView& fm, int c, int& k, int& l,
                              int& s) {
  const int cc = fm_clamp3(c);
  k = fgdp_ld(fm.counts + cc);
  s = fgdp_ld(fm.counts + cc + 1) - k;
  l = fgdp_ld(fm.counts + 3 - cc);
}

// SA[idx], clamped to the table
FGDP_HD int fm_sa_lookup(const FmView& fm, int idx) {
  return fgdp_ld(fm.sa + fm_clampll(idx, fm.sa_len - 1));
}
