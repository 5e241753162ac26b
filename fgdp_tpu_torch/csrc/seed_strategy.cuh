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
// The lane runs its own steps until x >= len or the machine's step cap
// 2 L L. The torch-op loop runs every lane in lockstep and tests every 8
// steps whether any lane is live; a lane that is not live (x >= len, or
// not active) changes nothing in a step and never becomes live again, so
// the lockstep loop's extra steps leave it as it is, and a loop cut at
// the cap has run every lane exactly the cap's steps: the per-lane loop
// gives the same seeds, counts and flags.
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

FGDP_HD void k3_read(const K3Args& A, int rd) {
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
      const int a0 = seed_read_at(A.codes, A.L, rd, x);
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
    const int a = seed_read_at(A.codes, A.L, rd, j);
    const int b = seed_read_at(A.codes, A.L, rd, j + 1);
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
    fm_forward_extend2(A.fm, k, l, s, a, b, k1, l1, s1, k2, l2, s2);
    gb += 192;   // two whole rows
    k = k1;
    l = l1;
    s = s1;
    n = j;
    if (s1 < A.max_intv && j - m + 1 >= A.msl) {
      if (s1 > 0) seed_append(A.out, rd, cnt, ovf, m, n, k, s);
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
      if (s2 > 0) seed_append(A.out, rd, cnt, ovf, m, n, k, s);
      x = j + 1;
      started = false;
      continue;
    }
    j += 1;
  }
  A.count[rd] = cnt;
  A.overflow[rd] = ovf ? 1 : 0;
  if (A.work != nullptr) {
    seed_work_add(A.work, gb);
    seed_work_add(A.work + 2, steps);
    seed_work_max(A.work + 3, steps);
  }
}
