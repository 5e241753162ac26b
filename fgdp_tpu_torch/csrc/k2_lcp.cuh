// K2 of the LCP engine for ONE job lane: the ISA jump, the tree ascents,
// the forward extension and the backward pass's EXT/SHR steps; the logic
// of the k2_lcp kernel (k2_lcp.cu), also built on the host by
// host_twin.cc for the CPU tests.
//
// A transcription of the port's ops/smem_k2lcp.py (the JAX package's
// fgdp_tpu/ops/smem_k2lcp.py :72-245) for one lane. A job re-seeds a long
// K1 SMEM at its midpoint x with min_intv = occ + 1, from a text position
// pos of q[x ..]:
//   1. row = isa[pos]; ascend from the leaf while the parent is at least
//      d0 deep or the node holds fewer than min_intv rows (ascent_cap
//      steps, then the lane flags overflow)
//   2. when the interval of q[x .. n] still meets min_intv, extend it
//      forward two characters a step (forward_extend2) from the mirrored
//      ISA jump's ascent
//   3. the backward pass: K1's EXT and SHR with death at s < min_intv,
//      a seed only left of the last one (lastl), and death once the
//      match no longer covers x
// The per-lane loops of 1 and 2 are a lane's own: the torch loops only
// stop once every lane is done, and a finished lane's step changes
// nothing. The backward pass runs the wave machine of seed_waves.cuh.
#pragma once

#include "fm.cuh"
#include "seed_waves.cuh"

struct K2Args {
  FmView fm;
  const int* tree;            // int32[N + 1, 4]
  const int* isa;             // int32[N]
  const int* codes;           // int32[B, L]
  const int* lens;            // int32[B]
  const int* k_read;          // int32[NK]
  const int* job_x;
  const int* job_mi;
  const int* job_pos;
  const int* job_d0;
  const unsigned char* k_on;  // bool[NK]
  int NK, L, N, l2ref, msl, ascent_cap;
  SeedRows out;               // int32[NK, sj_cap] each
  int* count;                 // int32[NK]
  unsigned char* overflow;    // bool[NK]: the lane's seeds, ascents or
                              // backward pass overflowed
  long long* work;            // int64[4] (seed_waves.cuh) or null
};

struct K2Lane {
  int id;       // job, -1 for a thread's spare lane
  int rd, x, mi;
  int l, r, lo, hi, lastl, mode;
  int cnt;
  bool ovf, kept;
  int gb, steps;   // bytes gathered, steps taken (the work counters)
};

// _ascend from leaf [row, row + 1): (lo, hi, depth clipped to
// depth_floor, step-cap overflow)
FGDP_HD void k2_ascend(const K2Args& A, K2Lane& st, int row, bool on,
                       int depth_floor, int size_goal, int& lo, int& hi,
                       int& dpt, bool& go) {
  lo = row;
  hi = row + 1;
  dpt = SEED_INT32_MAX;
  go = on;
  for (int steps = 0; steps < A.ascent_cap && go; ++steps) {
    int e[4];
    seed_tree_parent(A.tree, A.N, lo, hi, e);
    st.gb += 32;
    ++st.steps;
    go = (e[0] >= depth_floor) || (hi - lo < size_goal);
    if (go) {
      lo = e[1];
      hi = e[2];
      dpt = e[0];
    }
  }
  dpt = fgdp_min(dpt, depth_floor);
}

// steps 1 and 2, and the backward pass's start state
FGDP_HD void k2_lane_init(const K2Args& A, K2Lane& st, int id) {
  st.id = id < A.NK ? id : -1;
  st.cnt = 0;
  st.ovf = false;
  st.kept = st.id >= 0;
  st.mode = SEED_DEAD;
  st.rd = st.x = st.mi = st.l = st.r = st.lo = st.hi = 0;
  st.lastl = SEED_INT32_MAX;
  st.gb = st.steps = 0;
  if (st.id < 0 || !A.k_on[st.id]) return;
  const int j_id = st.id;
  st.rd = fgdp_ld(A.k_read + j_id);
  st.x = fgdp_ld(A.job_x + j_id);
  st.mi = fgdp_ld(A.job_mi + j_id);
  const int pos = fgdp_ld(A.job_pos + j_id);
  const int d0 = fgdp_ld(A.job_d0 + j_id);
  const int len = fgdp_ld(A.lens + st.rd);
  const int clampN = A.N - 1;

  // 1. ISA jump + ascent to the interval of q[x .. n]
  const int row = fgdp_ld(A.isa + fgdp_min(fgdp_max(pos, 0), clampN));
  int lo, hi, dpt;
  bool asc_ovf;
  st.gb += 4;
  k2_ascend(A, st, row, true, d0, st.mi, lo, hi, dpt, asc_ovf);

  // 2. forward extension past the parent SMEM's right end
  const int n0 = st.x + dpt - 1;
  const bool fwd_need = dpt >= d0 && n0 + 1 < len;
  bool masc_ovf = false;
  int fk = lo, fs = hi - lo, fn = n0;
  if (fwd_need) {
    const int mpos = (int)((unsigned)A.l2ref - (unsigned)pos - (unsigned)d0);
    const int mrow = fgdp_ld(A.isa + fgdp_min(fgdp_max(mpos, 0), clampN));
    int mlo, mhi, mdpt;
    st.gb += 4;
    k2_ascend(A, st, mrow, true, d0, 1, mlo, mhi, mdpt, masc_ovf);
    int fl = mlo;
    for (;;) {
      const int j = fn + 1;
      const int a = seed_read_at(A.codes, A.L, st.rd, j);
      if (!(j < len && a < 4)) break;
      const int b = seed_read_at(A.codes, A.L, st.rd, j + 1);
      int k1, l1, s1, k2, l2, s2;
      fm_forward_extend2(A.fm, fk, fl, fs, a, b, k1, l1, s1, k2, l2, s2);
      st.gb += 192;   // two whole rows
      ++st.steps;
      if (!(s1 >= st.mi)) break;
      fk = k1;
      fl = l1;
      fs = s1;
      fn = j;
      const int j1 = j + 1;
      if (!(j1 < len && b < 4 && s2 >= st.mi)) break;
      fk = k2;
      fl = l2;
      fs = s2;
      fn = j1;
    }
  }
  st.l = st.x;
  st.r = fwd_need ? fn + 1 : st.x + dpt;
  st.lo = fwd_need ? fk : lo;
  st.hi = fwd_need ? fk + fs : hi;
  st.mode = SEED_EXT;
  st.ovf = asc_ovf || masc_ovf;
  if (A.work != nullptr) seed_work_max(A.work + 3, st.steps);
}

FGDP_HD void k2_ext(const K2Args& A, K2Lane& st) {
  const int l = st.l, r = st.r, lo = st.lo, hi = st.hi, s = hi - lo;
  const bool at_end = l == 0;
  const int a = seed_read_at(A.codes, A.L, st.rd, l - 1);
  const int b = seed_read_at(A.codes, A.L, st.rd, l - 2);
  const bool va = a < 4;
  int k1 = 0, s1 = 0, k2 = 0, s2 = 0;
  if (!at_end && va) {
    fm_backward_extend2(A.fm, lo, s, a, b, k1, s1, k2, s2);
    st.gb += 48;
  }
  ++st.steps;
  const bool try1 = !at_end && va;
  const bool ok1 = try1 && s1 >= st.mi;
  const bool stuck1 = try1 && !(s1 >= st.mi);
  const bool bad1 = !at_end && !va;   // N: the job cannot cross it
  const bool emit1 =
      (at_end || stuck1 || bad1) && (r - l >= A.msl) && (l < st.lastl);
  const int l1x = ok1 ? l - 1 : l;
  const int lo1x = ok1 ? k1 : lo;
  const int hi1x = ok1 ? k1 + s1 : hi;
  // step 2: lanes that took step 1
  const bool at_end2 = ok1 && l1x == 0;
  const bool vb = b < 4;
  const bool bad2 = ok1 && !at_end2 && !vb;
  const bool try2 = ok1 && !at_end2 && vb;
  const bool ok2 = try2 && s2 >= st.mi;
  const bool stuck2 = try2 && !(s2 >= st.mi);
  const bool emit2 = (at_end2 || stuck2 || bad2) && (r - l1x >= A.msl) &&
                     (l1x < st.lastl);
  if (emit1 || emit2)
    seed_append(A.out, st.id, st.cnt, st.ovf, emit2 ? l1x : l, r - 1,
                emit2 ? k1 : lo, emit2 ? s1 : s);
  if (emit1)
    st.lastl = l;
  else if (emit2)
    st.lastl = l1x;
  st.l = ok2 ? l1x - 1 : l1x;
  st.lo = ok2 ? k2 : lo1x;
  st.hi = ok2 ? k2 + s2 : hi1x;
  if (at_end || bad1 || at_end2 || bad2)
    st.mode = SEED_DEAD;
  else if (stuck1 || stuck2)
    st.mode = SEED_SHR;
}

FGDP_HD void k2_shr(const K2Args& A, K2Lane& st) {
  int e[4];
  seed_tree_parent(A.tree, A.N, st.lo, st.hi, e);
  st.gb += 32;
  ++st.steps;
  const int d = fgdp_max(e[0], 0);
  const int new_r = st.l + d;
  const bool covers = new_r > st.x;   // the match must still contain x
  const int a = seed_read_at(A.codes, A.L, st.rd, st.l - 1);
  const bool can = ((e[3] >> fm_clamp3(a)) & 1) == 1;
  if (!covers)
    st.mode = SEED_DEAD;
  else if (can)
    st.mode = SEED_EXT;
  st.r = new_r;
  st.lo = e[1];
  st.hi = e[2];
}

struct K2Step {
  const K2Args& A;
  FGDP_HD void operator()(K2Lane& st, int mode) const {
    if (mode == SEED_EXT)
      k2_ext(A, st);
    else
      k2_shr(A, st);
  }
};

// the backward pass over a thread's lanes (initialised by k2_lane_init)
template <class Grid, class Lanes>
FGDP_HD void k2_machine(const K2Args& A, Grid& g, Lanes& ln,
                        int max_rounds) {
  K2Step step{A};
  seed_wave_phase<SEED_EXT, SEED_SHR>(g, ln, max_rounds, step,
                                      SEED_B_START);
}

FGDP_HD void k2_lane_finish(const K2Args& A, const K2Lane& st) {
  if (st.id < 0) return;
  A.count[st.id] = st.cnt;
  A.overflow[st.id] = (st.ovf || st.mode != SEED_DEAD) ? 1 : 0;
  if (A.work != nullptr) {
    seed_work_add(A.work, st.gb);
    seed_work_add(A.work + 2, st.steps);
  }
}
