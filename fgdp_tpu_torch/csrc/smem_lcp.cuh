// K1 of the LCP engine for ONE read lane: the EXT, WALK and SHR steps
// and the straggler cascade around the wave machine (seed_waves.cuh);
// the logic of the smem_lcp kernel (smem_lcp.cu), also built on the
// host by host_twin.cc for the CPU tests.
//
// A transcription of the port's ops/smem_lcp.py (the JAX package's
// fgdp_tpu/ops/smem_lcp.py :50-279) for one lane:
//   EXT   two characters a step by backward_extend2; a seed is emitted
//         at a step-1 or step-2 maximal point (read start, empty
//         interval, N) when it is at least min_seed_len long; an empty
//         match restarts left of the character; an interval of one
//         suffix goes to WALK
//   WALK  compares q[l-1-j] with text[pos-1-j], j < LCP_WALK_T, from the
//         reference's packed words (pos from SA at the walk's first
//         step); its seed carries the direct encoding k = -pos - 2; a
//         mismatch re-enters the row space at isa[pos] and goes to SHR,
//         a read N restarts left of it
//   SHR   ascends to the parent node (the deeper endpoint's tree row)
//         and goes back to EXT when the node can be prepended with
//         q[l-1], or at the root (d == 0), whose empty match skips it
// The cascade: a phase of 10 rounds over every lane, then two of 14 and
// max_rounds rounds over the first max(B >> 1, 8), then max(B >> 3, 8)
// live lanes in lane order (a stable prefix sum of the live flags);
// live lanes past those are flagged dropped and keep their state. A
// read still live at the end, or dropped, flags overflow.
#pragma once

#include "fm.cuh"
#include "seed_waves.cuh"

#define LCP_WALK_T 64   // characters a WALK step compares

struct LcpArgs {
  FmView fm;
  const int* tree;              // int32[N + 1, 4] (lcp, left, right, mask)
  const int* isa;               // int32[N]
  const int* codes;             // int32[B, L]
  const int* lens;              // int32[B]
  const unsigned char* active;  // bool[B]
  const long long* words;       // the packed reference (codes16)
  long long nwords;
  int B, L, N, l2ref, msl;
  SeedRows out;                 // int32[B, S] each
  int* count;                   // int32[B]
  unsigned char* overflow;      // bool[B]
  long long* work;              // int64[4] (seed_waves.cuh) or null
};

struct LcpLane {
  int id;       // read, -1 for a thread's spare lane
  int len;
  int l, r, lo, hi, pos, mode;
  int cnt;
  bool ovf, kept, dropped;
  int gb, steps;   // bytes gathered, steps taken (the work counters)
};

// read character of the WALK window: N and positions outside [0, len)
// are 4 (pack_reads + read_window; a position at or past L packs as 0)
FGDP_HD int lcp_read_win(const LcpArgs& A, const LcpLane& st, int p) {
  if (p < 0 || p >= st.len) return 4;
  if (p >= A.L) return 0;
  const int c = fgdp_ld(A.codes + (long long)st.id * A.L + p);
  return (c < 0 || c >= 4) ? 4 : c;
}

// text character at doubled-space position p, 4 outside [0, l2ref)
// (packed_window)
FGDP_HD int lcp_text_at(const LcpArgs& A, int p) {
  if (p < 0 || p >= A.l2ref) return 4;
  const long long w = fm_clampll((long long)(p >> 4), A.nwords - 1);
#ifdef __CUDA_ARCH__
  const unsigned word = (unsigned)__ldg(A.words + w);
#else
  const unsigned word = (unsigned)A.words[w];
#endif
  return (int)((word >> (2 * (p & 15))) & 3u);
}

FGDP_HD void lcp_lane_init(const LcpArgs& A, LcpLane& st, int id) {
  st.id = id < A.B ? id : -1;
  st.len = st.id >= 0 ? fgdp_ld(A.lens + st.id) : 0;
  st.l = st.r = st.len;
  st.lo = 0;
  st.hi = A.N;
  st.pos = -1;
  st.mode = (st.id >= 0 && A.active[st.id] && st.len > 0) ? SEED_EXT
                                                           : SEED_DEAD;
  st.cnt = 0;
  st.ovf = false;
  st.kept = st.id >= 0;
  st.dropped = false;
  st.gb = st.steps = 0;
}

FGDP_HD void lcp_ext(const LcpArgs& A, LcpLane& st) {
  const int l = st.l, r = st.r, lo = st.lo, hi = st.hi, s = hi - lo;
  const bool at_end = l == 0;
  const int a = seed_read_at(A.codes, A.L, st.id, l - 1);
  const int b = seed_read_at(A.codes, A.L, st.id, l - 2);
  const bool va = a < 4;
  int k1 = 0, s1 = 0, k2 = 0, s2 = 0;
  if (!at_end && va) {
    fm_backward_extend2(A.fm, lo, s, a, b, k1, s1, k2, s2);
    st.gb += 48;   // two rows' counts and packed words
  }
  ++st.steps;
  const bool try1 = !at_end && va;
  const bool ok1 = try1 && s1 > 0;
  const bool stuck1 = try1 && !(s1 > 0);
  const bool bad1 = !at_end && !va;
  const bool emit1 = (at_end || stuck1 || bad1) && (r - l >= A.msl);
  const bool empty1 = r == l;
  const bool skip1 = bad1 || (stuck1 && empty1);
  const bool to_shr1 = stuck1 && !empty1;
  const int l1x = (ok1 || skip1) ? l - 1 : l;
  const int r1x = skip1 ? l - 1 : r;
  const int lo1x = ok1 ? k1 : (skip1 ? 0 : lo);
  const int hi1x = ok1 ? k1 + s1 : (skip1 ? A.N : hi);
  const bool to_walk1 = ok1 && s1 == 1;
  const bool cont = ok1 && s1 > 1;
  // step 2: lanes that took step 1 with s1 > 1
  const bool at_end2 = cont && l1x == 0;
  const bool vb = b < 4;
  const bool bad2 = cont && !at_end2 && !vb;
  const bool try2 = cont && !at_end2 && vb;
  const bool ok2 = try2 && s2 > 0;
  const bool stuck2 = try2 && !(s2 > 0);
  const bool emit2 = (at_end2 || stuck2 || bad2) && (r - l1x >= A.msl);
  // the two emissions exclude each other: one append
  if (emit1 || emit2)
    seed_append(A.out, st.id, st.cnt, st.ovf, emit2 ? l1x : l, r - 1,
                emit2 ? k1 : lo, emit2 ? s1 : s);
  const bool skip2 = bad2;
  st.l = (ok2 || skip2) ? l1x - 1 : l1x;
  st.r = skip2 ? l1x - 1 : r1x;
  st.lo = ok2 ? k2 : (skip2 ? 0 : lo1x);
  st.hi = ok2 ? k2 + s2 : (skip2 ? A.N : hi1x);
  const bool to_walk = to_walk1 || (ok2 && s2 == 1);
  if (at_end || at_end2)
    st.mode = SEED_DEAD;
  else if (to_shr1 || stuck2)
    st.mode = SEED_SHR;
  else if (to_walk)
    st.mode = SEED_WALK;
  // a walk lane looks its position up at its first WALK step
  if (to_walk) st.pos = -1;
}

FGDP_HD void lcp_walk(const LcpArgs& A, LcpLane& st) {
  const int l = st.l, r = st.r;
  const int pos = st.pos < 0 ? fm_sa_lookup(A.fm, st.lo) : st.pos;
  if (st.pos < 0) st.gb += 4;
  int d = LCP_WALK_T, rb_d = 0;
  for (int j = 0; j < LCP_WALK_T; ++j) {
    const int rb = lcp_read_win(A, st, l - 1 - j);
    const int tb = lcp_text_at(A, pos - 1 - j);
    if (!(rb == tb && rb < 4 && tb < 4)) {
      d = j;
      rb_d = rb;
      break;
    }
  }
  const int l2 = l - d, pos2 = pos - d;
  const bool stop = d < LCP_WALK_T;
  // the packed words of the text positions compared
  const int last = pos - (stop ? d + 1 : d);
  st.gb += 8 * (((pos - 1) >> 4) - (last >> 4) + 1);
  ++st.steps;
  const bool at_start = stop && l2 == 0;
  const bool badchar = stop && !at_start && rb_d >= 4;   // N at l2 - 1
  const bool mism = stop && !at_start && !badchar;   // mismatch, text end
  if (stop && r - l2 >= A.msl)
    seed_append(A.out, st.id, st.cnt, st.ovf, l2, r - 1, -pos2 - 2, 1);
  st.l = badchar ? l2 - 1 : l2;
  if (badchar) st.r = l2 - 1;
  if (mism) {
    // re-enter the row space at the single suffix's SA row
    const int loI = fgdp_ld(A.isa + fgdp_min(fgdp_max(pos2, 0), A.N - 1));
    st.gb += 4;
    st.lo = loI;
    st.hi = loI + 1;
    st.mode = SEED_SHR;
  } else if (badchar) {
    st.lo = 0;
    st.hi = A.N;
    st.mode = SEED_EXT;
  } else if (at_start) {
    st.mode = SEED_DEAD;
  }
  st.pos = stop ? -1 : pos2;
}

FGDP_HD void lcp_shr(const LcpArgs& A, LcpLane& st) {
  int e[4];
  seed_tree_parent(A.tree, A.N, st.lo, st.hi, e);
  st.gb += 32;
  ++st.steps;
  const int d = fgdp_max(e[0], 0);
  const int a = seed_read_at(A.codes, A.L, st.id, st.l - 1);
  const bool can = ((e[3] >> fm_clamp3(a)) & 1) == 1;
  st.lo = e[1];
  st.hi = e[2];
  st.r = st.l + d;
  // d == 0 hands an unextendable root back to EXT, whose empty-match
  // path skips the character
  if (can || d == 0) st.mode = SEED_EXT;
}

struct LcpStep {
  const LcpArgs& A;
  FGDP_HD void operator()(LcpLane& st, int mode) const {
    if (mode == SEED_EXT)
      lcp_ext(A, st);
    else if (mode == SEED_WALK)
      lcp_walk(A, st);
    else
      lcp_shr(A, st);
  }
};

// The whole K1 machine over a thread's lanes (the lanes initialised by
// lcp_lane_init); `g` takes the counts over every thread's lanes.
template <class Grid, class Lanes>
FGDP_HD void lcp_machine(const LcpArgs& A, Grid& g, Lanes& ln,
                         int max_rounds) {
  const int waves[3] = {SEED_EXT, SEED_WALK, SEED_SHR};
  LcpStep step{A};
  seed_wave_phase(g, ln, 10, waves, 3, step);
  const int caps[2] = {14, max_rounds};
  for (int level = 1; level <= 2; ++level) {
    const int NC = fgdp_max(A.B >> (2 * level - 1), 8);
    if (A.B <= NC) {
      for (int i = 0; i < (int)ln.size(); ++i) ln[i].kept = ln[i].id >= 0;
    } else {
      // stable compaction: the first NC live lanes in lane order
      int mine = 0;
      for (int i = 0; i < (int)ln.size(); ++i)
        mine += ln[i].mode != SEED_DEAD;
      int rank = g.exscan(mine);
      for (int i = 0; i < (int)ln.size(); ++i) {
        const bool live = ln[i].mode != SEED_DEAD;
        ln[i].kept = live && rank < NC;
        if (live && rank >= NC) ln[i].dropped = true;
        rank += live;
      }
    }
    seed_wave_phase(g, ln, caps[level - 1], waves, 3, step);
  }
}

FGDP_HD void lcp_lane_finish(const LcpArgs& A, const LcpLane& st) {
  if (st.id < 0) return;
  A.count[st.id] = st.cnt;
  A.overflow[st.id] = (st.ovf || st.mode != SEED_DEAD || st.dropped) ? 1
                                                                      : 0;
  if (A.work != nullptr) {
    seed_work_add(A.work, st.gb);
    seed_work_add(A.work + 2, st.steps);
  }
}
