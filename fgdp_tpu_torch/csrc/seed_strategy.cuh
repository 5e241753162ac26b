// K3 (the seed strategy) for ONE read: the logic of the seed_strategy
// kernel (seed_strategy.cu), also built on the host by host_twin.cc for
// the CPU tests.
//
// A transcription of the port's ops/smem.py _seed_strategy_loop (the JAX
// package's fgdp_tpu/ops/smem.py :872, bwtSeedStrategyAllPosOneThread,
// FMI_search.cpp:1400-1488) for one lane. Each step either restarts at
// anchor x (the one-base interval of q[x], or x + 1 past an N) or
// extends forward two characters (forward_extend2 from one pair of
// rows): a character past the read end or an N ends the anchor, and an
// interval below max_intv at least min_seed_len long ends it with a
// seed when the interval is not empty.
//
// The read runs its own steps until x >= len or the machine's step cap
// 2 L L. The torch-op loop runs every lane in lockstep and tests every 8
// steps whether any lane is live; a lane that is not live (x >= len, or
// not active) changes nothing in a step and never becomes live again, so
// the lockstep loop's extra steps leave it as it is, and a loop cut at
// the cap has run every lane exactly the cap's steps: the per-read loop
// gives the same seeds, counts and flags.
//
// A read is a group of FM_GROUP = 16 lanes (the policy `grp`: a half
// warp on the card, 16 lockstep lanes in the host twin). The read's
// state (x, j, k, l, s, m, n, started, the seed count and flag) is the
// same in every lane of the group, so the group takes one branch; an
// extension's ranks are one a lane (fm_forward_extend2_group). The read's
// codes are read once, clamped to -1..4 (every test of the loop is
// "< 4" or clamps to 0..3, so the clamp changes nothing), into the
// group's byte buffer (shared memory on the card) or, for reads too long
// for it, read where they lie (K3Codes).
#pragma once

#include "fm.cuh"
#include "seed_waves.cuh"

struct K3Args {
  FmView fm;
  const int* codes;             // int32[B, L]
  const int* lens;              // int32[B]
  const unsigned char* active;  // bool[B]
  int B, L, max_intv, msl;
  SeedRows out;                 // int32[B, S] each
  int* count;                   // int32[B]
  unsigned char* overflow;      // bool[B]
  long long* work;              // int64[4] (seed_waves.cuh) or null
};

// codes[rd, j], j outside [0, L) -> 4: from the group's staged bytes
// (buf non-null) or from the codes tensor itself
struct K3Codes {
  const signed char* buf;
  const int* row;
  int L;
  FGDP_HD int at(int j) const {
    if (j < 0 || j >= L) return 4;
    return buf != nullptr ? (int)buf[j] : fgdp_ld(row + j);
  }
};

FGDP_HD signed char k3_code8(int c) {
  return (signed char)fgdp_min(fgdp_max(c, -1), 4);
}

// seed_append by a group: every lane counts, the lead lane writes
template <class Group>
FGDP_HD void k3_emit(const K3Args& A, const Group& grp, int rd, int& cnt,
                     bool& ovf, int m, int n, int k, int s) {
  if (cnt < A.out.S) {
    if (grp.lead()) {
      const long long at = (long long)rd * A.out.S + cnt;
      A.out.m[at] = m;
      A.out.n[at] = n;
      A.out.k[at] = k;
      A.out.s[at] = s;
    }
    ++cnt;
  } else {
    ovf = true;
  }
}

// One read's steps by its group; `buf` is the group's L-byte buffer or
// null (read the codes where they lie).
template <class Group>
FGDP_HD void k3_read(const K3Args& A, int rd, const Group& grp,
                     signed char* buf) {
  const int* row = A.codes + (long long)rd * A.L;
  if (buf != nullptr) grp.stage(buf, row, A.L);
  const K3Codes q{buf, row, A.L};
  const int len = fgdp_ld(A.lens + rd);
  const bool on = A.active[rd] != 0;
  const long long step_cap = 2LL * A.L * A.L;
  int x = 0, j = 0, k = 0, l = 0, s = 0, m = 0, n = 0, cnt = 0;
  bool started = false, ovf = false;
  long long steps = 0;
  int gb = 0;
  for (; steps < step_cap && on && x < len; ++steps) {
    const bool extl = started;
    if (!started) {
      // anchor restart
      const int a0 = q.at(x);
      if (a0 < 4) {
        fm_init_interval(A.fm, a0, k, l, s);
        m = n = x;
        j = x + 1;
        started = true;
      } else {
        x += 1;
      }
    }
    if (!extl) continue;
    // extension: two characters from one pair of rows
    const int a = q.at(j);
    const int b = q.at(j + 1);
    // char 0 at j
    if (j >= len) {
      x = j;
      started = false;
      continue;
    }
    if (a >= 4) {
      x = j + 1;
      started = false;
      continue;
    }
    int k1, l1, s1, k2, l2, s2;
    fm_forward_extend2_group(A.fm, grp, k, l, s, a, b, k1, l1, s1, k2, l2,
                             s2);
    gb += 192;   // two whole rows
    k = k1;
    l = l1;
    s = s1;
    n = j;
    if (s1 < A.max_intv && j - m + 1 >= A.msl) {
      if (s1 > 0) k3_emit(A, grp, rd, cnt, ovf, m, n, k, s);
      x = j + 1;
      started = false;
      continue;
    }
    j += 1;
    // char 1 at the old j + 1
    if (j >= len) {
      x = j;
      started = false;
      continue;
    }
    if (b >= 4) {
      x = j + 1;
      started = false;
      continue;
    }
    k = k2;
    l = l2;
    s = s2;
    n = j;
    if (s2 < A.max_intv && j - m + 1 >= A.msl) {
      if (s2 > 0) k3_emit(A, grp, rd, cnt, ovf, m, n, k, s);
      x = j + 1;
      started = false;
      continue;
    }
    j += 1;
  }
  if (grp.lead()) {
    A.count[rd] = cnt;
    A.overflow[rd] = ovf ? 1 : 0;
    if (A.work != nullptr) {
      seed_work_add(A.work, gb);
      seed_work_max(A.work + 1, gb / 192);   // the read's gather steps
      seed_work_add(A.work + 2, steps);
      seed_work_max(A.work + 3, steps);
    }
  }
}
