// The sweep's backward phase (D10) for ONE entry lane: the logic of the
// sweep_bwd kernel (sweep_bwd.cu), also built on the host by
// host_twin.cc for the CPU tests.
//
// A transcription of the port's ops/smem_sweep.py bwd_entries_plain (the
// JAX package's fgdp_tpu/ops/smem_sweep.py:359 bwd_entries) for one
// lane: the entry's interval extends leftward two characters a step by
// backward_extend2 until it falls below min_intv, meets an N or the
// read's start, or narrows to one suffix (s == 1: the lane pauses); a
// paused lane then compares the read leftward from m with the text
// leftward from its SA position, 64 characters a step (one packed
// compare of two 128-bit windows, the highest bad slot ends the match),
// and its result carries the direct encoding kf = -(pos0 + m) - 2. The
// torch-op loops compact their stragglers into narrower machines; a
// lane's result does not depend on that, so here each lane runs alone.
#pragma once

#include "sweep_fwd.cuh"

struct SweepBwdArgs {
  FmView fm;
  const int* codes;               // int32[B, L]
  const int* lens;                // int32[B]
  const int* rid;                 // int32[NL] the entry's read
  const int* anc;                 // int32[NL] its anchor (the start m)
  const int* k;                   // int32[NL] its interval
  const int* s;
  const int* mi;                  // int32[NL] its min_intv
  const unsigned char* on;        // bool[NL]
  const long long* words;         // the packed reference (codes16)
  long long nwords;
  int B, L, NL, l2ref;
  int* out_m;                     // int32[NL] each
  int* out_kf;
  int* out_sf;
  long long* work;                // int64[4] (seed_waves.cuh) or null
};

// The bad slots of a 64-slot compare of the read window at rstart (the
// codes read where they lie) with the text window at tstart: a
// mismatch, a read slot that reads 4 (rbad), a text position outside
// [0, l2ref)
FGDP_HD void sweep_compare(const int* codes, int L, int rid, int len,
                           const long long* words, long long nwords,
                           int l2ref, int rstart, int tstart,
                           lcp_u64 bad[2], lcp_u64 rbad[2]) {
  lcp_u64 rc[2], tc[2], tout[2];
  const SweepCodes<false> q{nullptr, codes + (long long)rid * L, L, 0};
  q.window(len, rstart, rc, rbad);
  lcp_text_window(words, nwords, tstart, tc);
  lcp_slots_outside((long long)tstart, l2ref, tout);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const lcp_u64 x = rc[h] ^ tc[h];
    bad[h] = ((x | (x >> 1)) & LCP_EVEN) | rbad[h] | tout[h];
  }
}

FGDP_HD void sweep_bwd_lane(const SweepBwdArgs& A, int lane) {
  const int rid = fgdp_ld(A.rid + lane);
  const bool on = A.on[lane] != 0;
  const int mi = fgdp_ld(A.mi + lane);
  int m = fgdp_ld(A.anc + lane), k = fgdp_ld(A.k + lane),
      s = fgdp_ld(A.s + lane);
  bool alive = on && s > 1 && m > 0;
  bool paused = on && s == 1;
  long long gb = 0, steps = 0;
  while (alive) {
    ++steps;
    const int jb = m - 1;
    const int a = seed_read_at(A.codes, A.L, rid, jb);
    const int b = seed_read_at(A.codes, A.L, rid, jb - 1);
    alive = false;
    if (jb >= 0 && a < 4) {
      int k1, s1, k2, s2;
      fm_backward_extend2(A.fm, k, s, a, b, k1, s1, k2, s2);
      gb += 48;
      if (s1 >= mi) {
        m = jb;
        k = k1;
        s = s1;
        if (s1 == 1) {
          paused = true;
        } else if (jb - 1 >= 0 && b < 4 && s2 >= mi) {
          m = jb - 1;
          k = k2;
          s = s2;
          if (s2 == 1)
            paused = true;
          else
            alive = true;
        }
      }
    }
  }
  long long gsteps = steps;
  int kf = k;
  if (paused) {
    // the single-suffix walk: read [m - 64, m) against text
    // [pos0 + m - 64, pos0 + m), reversed
    const int pos0 = fm_sa_lookup(A.fm, k) - m;
    const int len = fgdp_ld(A.lens + rid);
    gb += 4;
    ++gsteps;
    bool going = m > 0;
    while (going) {
      ++steps;
      lcp_u64 bad[2], rbad[2];
      sweep_compare(A.codes, A.L, rid, len, A.words, A.nwords, A.l2ref,
                    m - SWEEP_WALK_T, pos0 + m - SWEEP_WALK_T, bad, rbad);
      gb += 40;
      ++gsteps;
      int lcp = SWEEP_WALK_T;
      if (bad[0] | bad[1]) {
        const bool h = bad[1] != 0;
        const int bit = lcp_top_bit(h ? bad[1] : bad[0]);
        lcp = SWEEP_WALK_T - 1 - ((h ? 32 : 0) + (bit >> 1));
      }
      m -= lcp;
      going = lcp == SWEEP_WALK_T && m > 0;
    }
    kf = -(pos0 + m) - 2;
  }
  A.out_m[lane] = m;
  A.out_kf[lane] = kf;
  A.out_sf[lane] = s;
  if (A.work != nullptr && on) {
    seed_work_add(A.work, gb);
    seed_work_max(A.work + 1, gsteps);
    seed_work_add(A.work + 2, steps);
    seed_work_max(A.work + 3, steps);
  }
}
