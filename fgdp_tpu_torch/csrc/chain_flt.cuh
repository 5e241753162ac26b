// The chain filter for ONE read: the per-warp logic of the chain_flt
// kernel (chain_flt.cu), also built on the host by host_twin.cc for the
// CPU tests (32 lanes in lockstep).
//
// A transcription of fgdp_tpu/align/chain.py _chain_flt (the reference's
// mem_chain_flt, src/bwamem.cpp:529), the plain version
// align/chain.chain_flt_plain. The read's chains that weigh at least
// min_chain_weight are walked heaviest first (ties by pos, then by slot:
// the two stable sorts of the plain version); a chain is dropped (0)
// when it overlaps a kept, heavier one by mask_level of the shorter and
// weighs less than drop_ratio of it (by at least 2 min_seed_len), else
// kept as 2 (it overlaps a kept one) or 3. The first chain each kept one
// overlaps becomes a shadow (1); the (max_chain_extend)-th chain kept as
// 1 or 2 and every later one below 3 are cut to 0. Integer compares and
// the two float32 products in the same order and rounding as the plain
// version (an int rounded to float32 to nearest, the option as float32,
// one rounded multiply, no FMA), so the result is exactly equal.
//
// Layout: one warp a read, its chains in the warp's shared memory
// (FLT_NARR int arrays of C, FLT_* below). Slot c (insertion order) and
// rank r (filter order) belong to lane c % 32 and r % 32. Steps:
//   1. the slots' weights (-1 for a chain below min_chain_weight) and
//      pos into shared memory, n_f the ballots' popcounts;
//   2. each lane ranks its slots by counting the smaller keys
//      (-weight, pos, slot) over the read's n slots, broadcast from
//      shared memory, and scatters the slot's row to its rank;
//   3. rank i = 1 .. n_f - 1: one pass of the lanes over the ranks
//      j < i, 32 at a time: `sig` and `trig` are ballots, the first
//      trigger the lowest set bit of the first nonzero trigger word (the
//      pass stops there), `first` written by j's own lane;
//   4. shadow marks into a mark array, taken from `kept` before any mark
//      lands, then applied;
//   5. the max_chain_extend cut: a warp inclusive scan of the 1-or-2
//      flags, 32 ranks at a time;
//   6. every slot of the output row: its rank's flag, 0 for the others.
#pragma once

#include "common.cuh"

// the warp's shared arrays, each C ints: by slot (S_*) and by rank (R_*)
enum {
  FLT_S_W,     // weight, -1 below min_chain_weight (weights are >= 0)
  FLT_S_POS,   // pos
  FLT_S_RANK,  // the slot's rank, -1 below min_chain_weight
  FLT_R_W, FLT_R_BEG, FLT_R_END, FLT_R_ALT, FLT_R_KEPT, FLT_R_FIRST,
  FLT_R_MARK,
  FLT_NARR
};

struct FltArgs {
  const int* n;                 // [B] chains of the read (P2's n)
  const int* pos;               // [B, C] P2's table, insertion order
  const int* crid;
  const int* fq;
  const int* lq;
  const int* ll;
  const int* weight;            // [B, C] min(wq, wr), in [0, 2^30)
  const unsigned char* is_alt;  // [n_contigs] bool
  int n_contigs, B, C;
  int min_chain_weight, min_seed_len, max_chain_gap, max_chain_extend;
  float mask_level, drop_ratio;
  int* kept;                    // [B, C] out, insertion order
};

// x rounded to float32 to nearest, times m, rounded once: torch's and
// XLA's float32 tensor times a Python float (the float rounded to
// float32 first, by the caller)
FGDP_HD float flt_mul(int x, float m) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(__int2float_rn(x), m);
#else
  return (float)x * m;
#endif
}

// (float) d >= (float) x * m, as the plain version's mask_level test
FGDP_HD bool flt_ge_mul(int d, int x, float m) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(d) >= flt_mul(x, m);
#else
  return (float)d >= flt_mul(x, m);
#endif
}

// (float) a < (float) x * m, as the plain version's drop_ratio test
FGDP_HD bool flt_lt_mul(int a, int x, float m) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(a) < flt_mul(x, m);
#else
  return (float)a < flt_mul(x, m);
#endif
}

// Read b's kept flags into a.kept[b]; `sm` is the warp's FLT_NARR * C
// ints of shared memory.
template <class L>
FGDP_HD void chain_flt_read(const FltArgs& a, int b, int* sm,
                            const L& lanes) {
  using I = typename L::I;
  const int C = a.C;
  const long long row = (long long)b * C;
  const I lane = lanes.lane();
  int* s_w = sm + FLT_S_W * C;
  int* s_pos = sm + FLT_S_POS * C;
  int* s_rank = sm + FLT_S_RANK * C;
  int* r_w = sm + FLT_R_W * C;
  int* r_beg = sm + FLT_R_BEG * C;
  int* r_end = sm + FLT_R_END * C;
  int* r_alt = sm + FLT_R_ALT * C;
  int* r_kept = sm + FLT_R_KEPT * C;
  int* r_first = sm + FLT_R_FIRST * C;
  int* r_mark = sm + FLT_R_MARK * C;
  const int n = fgdp_max(fgdp_min(a.n[b], C), 0);

  // 1. weights and pos by slot; the rank arrays' flags cleared
  int nf = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const I c = lane + c0;
    const auto ok = c < n;
    const I w = lanes.load(a.weight + row, c, ok, 0);
    const auto big = ok & (w >= a.min_chain_weight);
    lanes.store_if(s_w, c, lanes.sel(big, w, -1), ok);
    lanes.store_if(s_pos, c, lanes.load(a.pos + row, c, ok, 0), ok);
    lanes.store_if(r_kept, c, I(0), ok);
    lanes.store_if(r_first, c, I(-1), ok);
    lanes.store_if(r_mark, c, I(0), ok);
    nf += fgdp_popc(lanes.ballot(big));
  }
  lanes.sync();

  // 2. ranks: the slots before c in (-weight, pos, slot) order, among
  // the chains at or above min_chain_weight; each row to its rank
  for (int c0 = 0; c0 < n; c0 += 32) {
    const I c = lane + c0;
    const auto ok = c < n;
    const I w = lanes.load(s_w, c, ok, -1);
    const I p = lanes.load(s_pos, c, ok, 0);
    I r = I(0);
    for (int c2 = 0; c2 < n; ++c2) {
      const int w2 = s_w[c2], p2 = s_pos[c2];
      r = r + lanes.sel((w < w2) | ((w2 == w) & ((p2 < p) |
                                                 ((p2 == p) & (c2 < c)))),
                        1, 0);
    }
    const auto big = ok & (w >= 0);
    lanes.store_if(s_rank, c, lanes.sel(big, r, -1), ok);
    const I fq = lanes.load(a.fq + row, c, big, 0);
    const I lq = lanes.load(a.lq + row, c, big, 0);
    const I ll = lanes.load(a.ll + row, c, big, 0);
    const I rid = lanes.load(a.crid + row, c, big, 0);
    // crid clamped to [0, n_contigs]; n_contigs is "not alt"
    const I ci = lanes.sel(rid < 0, 0, lanes.sel(a.n_contigs < rid,
                                                 a.n_contigs, rid));
    const I alt = lanes.load_u8(a.is_alt, ci, big & (ci < a.n_contigs));
    lanes.store_if(r_w, r, w, big);
    lanes.store_if(r_beg, r, fq, big);
    lanes.store_if(r_end, r, lq + ll, big);
    lanes.store_if(r_alt, r, lanes.sel(alt != 0, 1, 0), big);
  }
  lanes.sync();

  // 3. the filter, one rank step at a time
  if (nf > 0 && lanes.lead()) r_kept[0] = 3;
  lanes.sync();
  const int gap = a.max_chain_gap, min_w_gap = 2 * a.min_seed_len;
  for (int i = 1; i < nf; ++i) {
    const int bi = r_beg[i], ei = r_end[i], wi = r_w[i];
    const bool alt_i = r_alt[i] == 1;
    const int li = ei - bi;
    bool large = false, any_trig = false;
    for (int j0 = 0; j0 < i; j0 += 32) {
      const I j = lane + j0;
      const auto ok = j < i;
      const I bj = lanes.load(r_beg, j, ok, 0);
      const I ej = lanes.load(r_end, j, ok, 0);
      const I wj = lanes.load(r_w, j, ok, 0);
      const I aj = lanes.load(r_alt, j, ok, 0);
      const I kj = lanes.load(r_kept, j, ok, 0);
      const I fj = lanes.load(r_first, j, ok, 0);
      const I b_max = lanes.sel(bj < bi, bi, bj);
      const I e_min = lanes.sel(ej < ei, ej, ei);
      const I lj = ej - bj;
      const I min_l = lanes.sel(lj < li, lj, li);
      const auto sig = ok & (0 < kj) & (b_max < e_min) &
                       ((aj == 0) | alt_i) &
                       flt_ge_mul(e_min - b_max, min_l, a.mask_level) &
                       (min_l < gap);
      const auto trig = sig & flt_lt_mul(wi, wj, a.drop_ratio) &
                        (min_w_gap <= wj - wi);
      const unsigned sb = lanes.ballot(sig), tb = lanes.ballot(trig);
      large = large | (sb != 0);
      // `first`: the overlapping chains up to and with the first trigger
      const int last = tb != 0 ? j0 + fgdp_ctz(tb) : j0 + 31;
      lanes.store_if(r_first, j, I(i), sig & (fj == -1) & (j <= last));
      if (tb != 0) {
        any_trig = true;
        break;
      }
    }
    if (lanes.lead()) r_kept[i] = any_trig ? 0 : (large ? 2 : 3);
    lanes.sync();
  }

  // 4. shadows: every kept chain's `first` becomes 1, the targets read
  // before any mark lands
  for (int j0 = 0; j0 < nf; j0 += 32) {
    const I j = lane + j0;
    const auto ok = j < nf;
    const I kj = lanes.load(r_kept, j, ok, 0);
    const I fj = lanes.load(r_first, j, ok, -1);
    lanes.store_if(r_mark, fj, I(1), ok & (0 < kj) & (0 <= fj));
  }
  lanes.sync();
  for (int j0 = 0; j0 < nf; j0 += 32) {
    const I j = lane + j0;
    const auto ok = j < nf;
    const I kj = lanes.load(r_kept, j, ok, 0);
    const I mj = lanes.load(r_mark, j, ok, 0);
    lanes.store_if(r_kept, j, lanes.sel(mj != 0, 1, kj), ok);
  }
  lanes.sync();

  // 5. the max_chain_extend cut: the rank where the inclusive count of
  // flags 1 and 2 reaches it; from there every flag below 3 is 0
  int cut = nf, carry = 0;
  for (int r0 = 0; r0 < nf; r0 += 32) {
    const I r = lane + r0;
    const auto ok = r < nf;
    const I kr = lanes.load(r_kept, r, ok, 0);
    const auto is12 = ok & ((kr == 1) | (kr == 2));
    I x = lanes.sel(is12, 1, 0);
    for (int d = 1; d < 32; d *= 2) {
      const I y = lanes.shfl_up(x, d);
      x = x + lanes.sel(d <= lane, y, 0);
    }
    const unsigned hb = lanes.ballot(is12 & (a.max_chain_extend <= x + carry));
    if (hb != 0) {
      cut = r0 + fgdp_ctz(hb);
      break;
    }
    carry += lanes.shfl(x, 31);
  }
  for (int r0 = cut - (cut & 31); r0 < nf; r0 += 32) {
    const I r = lane + r0;
    const auto ok = (r < nf) & (cut <= r);
    const I kr = lanes.load(r_kept, r, ok, 3);
    lanes.store_if(r_kept, r, I(0), ok & (kr < 3));
  }
  lanes.sync();

  // 6. the output row in insertion order, every slot written
  for (int c0 = 0; c0 < C; c0 += 32) {
    const I c = lane + c0;
    const I rk = lanes.load(s_rank, c, c < n, -1);
    lanes.store_if(a.kept + row, c, lanes.load(r_kept, rk, 0 <= rk, 0),
                   c < C);
  }
}
