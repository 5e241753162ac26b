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
//         a read N restarts left of it. The 64 compares are one packed
//         compare of two 128-bit windows (lcp_walk below), not a loop
//         that stops at the first mismatch
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
  long long* work;              // int64[4 + 2 SEED_BUCKETS] or null
};

struct LcpLane {
  int id;       // read, -1 for a thread's spare lane
  int len;
  int l, r, lo, hi, pos, mode;
  int cnt;
  bool ovf, kept, dropped;
  int gb, steps;   // bytes gathered, steps taken (the work counters)
};

typedef unsigned long long lcp_u64;

#define LCP_EVEN 0x5555555555555555ull

// 32 positions of a staged read: the 2-bit codes (position 32 w + j at
// bits 2j, 2j + 1) and the N mask (bit 2j set where position 32 w + j
// reads 4 in the WALK window)
struct alignas(16) LcpWord {
  lcp_u64 c, n;
};

// the staged form of code c at a position inside [0, L): N where c is
// outside [0, 4); the 2-bit field of an N tells EXT's two kinds apart
// (1: c >= 4, which EXT reads as 4; 0: c < 0, which EXT clamps to 0)
FGDP_HD void lcp_stage_code(int c, int& code, int& n) {
  n = (c < 0 || c >= 4) ? 1 : 0;
  code = c >= 4 ? 1 : (c < 0 ? 0 : c);
}

// x's bits j at bits 2j
FGDP_HD lcp_u64 lcp_spread(unsigned x) {
  lcp_u64 v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

// word w of a code row of L positions in the staged form (positions at
// or past L: code 0, no N); the host twin of D9 stages its rows so
FGDP_HD LcpWord lcp_stage_row_word(const int* row, int L, int w) {
  LcpWord o{0, 0};
  for (int j = 0; j < 32; ++j) {
    const int p = 32 * w + j;
    if (p >= L) break;
    int code, n;
    lcp_stage_code(fgdp_ld(row + p), code, n);
    o.c |= (lcp_u64)code << (2 * j);
    o.n |= (lcp_u64)n << (2 * j);
  }
  return o;
}

// word w of read `id`'s staged row
FGDP_HD LcpWord lcp_stage_word(const LcpArgs& A, int id, int w) {
  return lcp_stage_row_word(A.codes + (long long)id * A.L, A.L, w);
}

// the 64 bits of (lo, hi) from bit sh (0..63) on: bits [sh, sh + 64) of
// the 128-bit value hi:lo
FGDP_HD lcp_u64 lcp_funnel(lcp_u64 lo, lcp_u64 hi, int sh) {
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

// the even bits of the slots below k (k clamped to [0, 64]) of a 64-slot
// window, as (slots 0-31, slots 32-63)
FGDP_HD void lcp_slots_below(long long k, lcp_u64 m[2]) {
  const int a = k < 0 ? 0 : (k > 64 ? 64 : (int)k);
  m[0] = a >= 32 ? LCP_EVEN : (LCP_EVEN & ((1ull << (2 * a)) - 1));
  m[1] = a <= 32 ? 0
                 : (a >= 64 ? LCP_EVEN
                            : (LCP_EVEN & ((1ull << (2 * (a - 32))) - 1)));
}

// the slots of the window [start, start + 64) whose position lies
// outside [0, end)
FGDP_HD void lcp_slots_outside(long long start, long long end,
                               lcp_u64 m[2]) {
  lcp_u64 below[2], inside[2];
  lcp_slots_below(-start, below);
  lcp_slots_below(end - start, inside);
  m[0] = below[0] | (LCP_EVEN & ~inside[0]);
  m[1] = below[1] | (LCP_EVEN & ~inside[1]);
}

// Read codes from the staged rows (shared memory on the card): `base`
// holds nw words a read, read `id` at row id - first.
struct LcpStaged {
  const LcpWord* base;
  int nw, first;
  const int* kc;   // C (4) then C2 (16): fm_backward_extend2's tables

  FGDP_HD const LcpWord* row(const LcpLane& st) const {
    return base + (long long)(st.id - first) * nw;
  }

  FGDP_HD LcpWord word(const LcpWord* rw, int w) const {
    return (w >= 0 && w < nw) ? rw[w] : LcpWord{0, 0};
  }

  // EXT's and SHR's code at p: seed_read_at's value, but a code below 0
  // as 0 (every use tests "< 4" or clamps to 0..3)
  FGDP_HD int at(const LcpArgs& A, const LcpLane& st, int p) const {
    if (p < 0 || p >= A.L) return 4;
    const LcpWord v = row(st)[p >> 5];
    const int sh = 2 * (p & 31);
    const int code = (int)((v.c >> sh) & 3u);
    return ((v.n >> sh) & 1u) ? (code ? 4 : 0) : code;
  }

  // the WALK window [start, start + 64): codes and N masks, slot i =
  // position start + i (positions below 0 or past the row: code 0)
  FGDP_HD void window(const LcpArgs&, const LcpLane& st, int start,
                      lcp_u64 c[2], lcp_u64 n[2]) const {
    const LcpWord* rw = row(st);
    const int w0 = start >> 5, sh = 2 * (start & 31);
    const LcpWord a = word(rw, w0), b = word(rw, w0 + 1),
                  d = word(rw, w0 + 2);
    c[0] = lcp_funnel(a.c, b.c, sh);
    c[1] = lcp_funnel(b.c, d.c, sh);
    n[0] = lcp_funnel(a.n, b.n, sh);
    n[1] = lcp_funnel(b.n, d.n, sh);
  }
};

// Read codes where they lie (int32[B, L] in global memory), for rows
// longer than the staged rows' shared memory holds.
struct LcpInPlace {
  const int* kc;

  FGDP_HD int at(const LcpArgs& A, const LcpLane& st, int p) const {
    return seed_read_at(A.codes, A.L, st.id, p);
  }

  FGDP_HD void window(const LcpArgs& A, const LcpLane& st, int start,
                      lcp_u64 c[2], lcp_u64 n[2]) const {
    const int* q = A.codes + (long long)st.id * A.L;
    c[0] = c[1] = n[0] = n[1] = 0;
    // four rounds of 16 loads in flight (64 at once cost registers)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lcp_u64 ch = 0, nh = 0;
#pragma unroll 16
      for (int i = 0; i < 32; ++i) {
        const int p = start + 32 * h + i;
        int code = 0, nb = 0;
        if (p >= 0 && p < A.L) lcp_stage_code(fgdp_ld(q + p), code, nb);
        ch |= (lcp_u64)(nb ? 0 : code) << (2 * i);
        nh |= (lcp_u64)nb << (2 * i);
      }
      c[h] = ch;
      n[h] = nh;
    }
  }
};

// the window's 64 slots from the five packed words v (words start >> 4
// on, each a uint32 of 16 codes)
FGDP_HD void lcp_text_slots(const lcp_u64 v[5], int start, lcp_u64 t[2]) {
  const int sh = 2 * (start & 15);
  const lcp_u64 a = v[0] | (v[1] << 32), b = v[2] | (v[3] << 32);
  t[0] = lcp_funnel(a, b, sh);
  t[1] = lcp_funnel(b, v[4], sh);
}

// the text's codes at [start, start + 64) (slot i = position start + i)
// from the five packed words (of `nwords`) that cover them, each index
// clamped to the table as packed_window's gather is; the sweep's kernels
// (sweep_fwd.cuh, sweep_bwd.cuh) take it too
FGDP_HD void lcp_text_window(const long long* words, long long nwords,
                             int start, lcp_u64 t[2]) {
  const long long w0 = (long long)(start >> 4);
  lcp_u64 v[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long w = fm_clampll(w0 + k, nwords - 1);
#ifdef __CUDA_ARCH__
    v[k] = (unsigned)__ldg(words + w);
#else
    v[k] = (unsigned)words[w];
#endif
  }
  lcp_text_slots(v, start, t);
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

template <class Rows>
FGDP_HD void lcp_ext(const LcpArgs& A, const Rows& rows, LcpLane& st) {
  const int l = st.l, r = st.r, lo = st.lo, hi = st.hi, s = hi - lo;
  const bool at_end = l == 0;
  const int a = rows.at(A, st, l - 1);
  const int b = rows.at(A, st, l - 2);
  const bool va = a < 4;
  int k1 = 0, s1 = 0, k2 = 0, s2 = 0;
  if (!at_end && va) {
    fm_backward_extend2(A.fm, rows.kc, rows.kc + 4, lo, s, a, b, k1, s1,
                        k2, s2);
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

// index of the highest set bit of x != 0
FGDP_HD int lcp_top_bit(lcp_u64 x) {
#ifdef __CUDA_ARCH__
  return 63 - __clzll((long long)x);
#else
  return 63 - __builtin_clzll(x);
#endif
}

// One WALK step: the first j < 64 where q[l-1-j] and text[pos-1-j]
// differ or either is 4 is the highest bad slot of the windows
// [l - 64, l) and [pos - 64, pos) (slot i is j = 63 - i): mismatches by
// an XOR of the 2-bit codes, read N, read positions outside [0, len) and
// text positions outside [0, l2ref) ORed in.
template <class Rows>
FGDP_HD void lcp_walk(const LcpArgs& A, const Rows& rows, LcpLane& st) {
  const int l = st.l, r = st.r;
  const int pos = st.pos < 0 ? fm_sa_lookup(A.fm, st.lo) : st.pos;
  if (st.pos < 0) st.gb += 4;
  lcp_u64 rc[2], rn[2], tc[2], rout[2], tout[2];
  rows.window(A, st, l - LCP_WALK_T, rc, rn);
  lcp_text_window(A.words, A.nwords, pos - LCP_WALK_T, tc);
  lcp_slots_outside((long long)l - LCP_WALK_T, st.len, rout);
  lcp_slots_outside((long long)pos - LCP_WALK_T, A.l2ref, tout);
  lcp_u64 rbad[2], bad[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const lcp_u64 x = rc[h] ^ tc[h];
    rbad[h] = rn[h] | rout[h];
    bad[h] = ((x | (x >> 1)) & LCP_EVEN) | rbad[h] | tout[h];
  }
  // the highest bad slot; d = 64 when none (selects, not a run-time
  // index, keep the halves in registers)
  int d = LCP_WALK_T;
  bool rb_bad = false;
  if (bad[1] | bad[0]) {
    const bool h = bad[1] != 0;
    const int bit = lcp_top_bit(h ? bad[1] : bad[0]);
    d = LCP_WALK_T - 1 - ((h ? 32 : 0) + (bit >> 1));
    rb_bad = (((h ? rbad[1] : rbad[0]) >> bit) & 1u) != 0;
  }
  const int l2 = l - d, pos2 = pos - d;
  const bool stop = d < LCP_WALK_T;
  // the packed words of the text positions compared
  const int last = pos - (stop ? d + 1 : d);
  st.gb += 8 * (((pos - 1) >> 4) - (last >> 4) + 1);
  ++st.steps;
  const bool at_start = stop && l2 == 0;
  const bool badchar = stop && !at_start && rb_bad;   // N at l2 - 1
  const bool mism = stop && !at_start && !badchar;    // mismatch, text end
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

template <class Rows>
FGDP_HD void lcp_shr(const LcpArgs& A, const Rows& rows, LcpLane& st) {
  int e[4];
  seed_tree_parent(A.tree, A.N, st.lo, st.hi, e);
  st.gb += 32;
  ++st.steps;
  const int d = fgdp_max(e[0], 0);
  const int a = rows.at(A, st, st.l - 1);
  const bool can = ((e[3] >> fm_clamp3(a)) & 1) == 1;
  st.lo = e[1];
  st.hi = e[2];
  st.r = st.l + d;
  // d == 0 hands an unextendable root back to EXT, whose empty-match
  // path skips the character
  if (can || d == 0) st.mode = SEED_EXT;
}

template <class Rows>
struct LcpStep {
  const LcpArgs& A;
  const Rows& rows;
  FGDP_HD void operator()(LcpLane& st, int mode) const {
    if (mode == SEED_EXT)
      lcp_ext(A, rows, st);
    else if (mode == SEED_WALK)
      lcp_walk(A, rows, st);
    else
      lcp_shr(A, rows, st);
  }
};

// The cascade's compaction before level `level` (1, 2): the first NC
// live lanes in lane order stay kept, the other live lanes drop.
template <class Grid, class Lanes>
FGDP_HD void lcp_compact(const LcpArgs& A, Grid& g, Lanes& ln, int level) {
  const int NC = fgdp_max(A.B >> (2 * level - 1), 8);
  if (A.B <= NC) {
    for (int i = 0; i < (int)ln.size(); ++i) ln[i].kept = ln[i].id >= 0;
    return;
  }
  // stable compaction: a prefix sum of the live flags
  int mine = 0;
  for (int i = 0; i < (int)ln.size(); ++i) mine += ln[i].mode != SEED_DEAD;
  int rank = g.exscan(mine, SEED_B_CASCADE + level - 1);
  for (int i = 0; i < (int)ln.size(); ++i) {
    const bool live = ln[i].mode != SEED_DEAD;
    ln[i].kept = live && rank < NC;
    if (live && rank >= NC) ln[i].dropped = true;
    rank += live;
  }
}

// The whole K1 machine over a thread's lanes (the lanes initialised by
// lcp_lane_init); `g` takes the counts over every thread's lanes, `step`
// advances a lane (LcpStep).
template <class Grid, class Lanes, class Step>
FGDP_HD void lcp_machine(const LcpArgs& A, Grid& g, Lanes& ln,
                         int max_rounds, Step step) {
  seed_wave_phase<SEED_EXT, SEED_WALK, SEED_SHR>(g, ln, 10, step,
                                                 SEED_B_START);
  lcp_compact(A, g, ln, 1);
  seed_wave_phase<SEED_EXT, SEED_WALK, SEED_SHR>(g, ln, 14, step,
                                                 SEED_B_CASCADE);
  lcp_compact(A, g, ln, 2);
  seed_wave_phase<SEED_EXT, SEED_WALK, SEED_SHR>(g, ln, max_rounds, step,
                                                 SEED_B_CASCADE + 1);
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
