// The sweep's forward phase (D9) for ONE lane: the logic of the
// sweep_fwd kernel (sweep_fwd.cu), also built on the host by
// host_twin.cc for the CPU tests.
//
// A transcription of the port's ops/smem_sweep.py fwd_sweep_plain (the
// JAX package's fgdp_tpu/ops/smem_sweep.py:129 fwd_sweep) for one lane,
// which runs its own steps to its own end: the torch-op loop's step is a
// no-op on a lane that has ended, so the loop's "any lane live" test is
// not needed. A step:
//   restart  a lane with no anchor in progress starts one at x
//            (init_interval), or skips an N at x
//   walk     an interval of one suffix (s == 1) compares the read from
//            j = n + 1 with the text from its SA position, 64 characters
//            a step (one packed compare of two 128-bit windows, the
//            lowest bad slot ends the match); a mismatch pushes the
//            interval, a read N or the read's end does not
//   occ      two forward extensions from the same two occ rows
//            (forward_extend2); each that shrinks the interval pushes
//            the interval before it; one below min_intv, an N or the
//            read's end ends the anchor
//   end      an ended anchor pushes its last interval when it is at
//            least min_intv, and restarts at next_x (restart) or ends
//            the lane (one anchor a lane, K2's shape)
// A push is capped twice: prev_cap pushes an anchor (povf), E entries a
// lane (eovf, for pushes that passed the anchor's cap). Entries land in
// the lane's row of em/en/ek/es in push order, so a dying anchor's
// death push and final push stay adjacent (flatten_entries drops the
// second).
//
// One difference from the torch-op loop: a started lane whose interval
// takes neither branch (s == 0, a base the reference lacks; or s == 1
// with walk off) never ends there; here it ends and flags eovf, so the
// read climbs the overflow ladder instead of hanging the card.
//
// A sweep lane is a group of FM_GROUP = 16 lanes (the policy `grp`: a
// half warp on the card, 16 lockstep lanes in the host twin). Its state
// is the same in every lane of the group, so the group takes one branch:
// an occ step's 16 ranks are one a lane (fm_forward_extend2_group), a
// walk step's five text words one a lane (sweep_text_window), and the
// lead lane writes the pushes and the results. The lane's read is staged
// once into the group's words in K1's form (2-bit codes and an N mask,
// so a walk step's read window is three shared-memory words), or, for
// rows too long for the block's buffers, read where it lies
// (SweepCodes).
#pragma once

#include "smem_lcp.cuh"

#define SWEEP_WALK_T 64   // characters a walk step compares

struct SweepFwdArgs {
  FmView fm;
  const int* codes;               // int32[B, L]
  const int* lens;                // int32[B]
  const int* rid;                 // int32[NL] the lane's read
  const int* x0;                  // int32[NL] its first anchor
  const int* min_intv;            // int32[NL]
  const unsigned char* active;    // bool[NL]
  const long long* words;         // the packed reference (codes16)
  long long nwords;
  int B, L, NL, E, prev_cap, l2ref;
  int* em;                        // int32[NL, E] each, zeroed
  int* en;
  int* ek;
  int* es;
  int* ecount;                    // int32[NL]
  unsigned char* povf;            // bool[NL]
  unsigned char* eovf;            // bool[NL]
  long long* work;                // int64[4] (seed_waves.cuh) or null
};

// index of the lowest set bit of x != 0
FGDP_HD int sweep_low_bit(lcp_u64 x) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)x) - 1;
#else
  return __builtin_ctzll(x);
#endif
}

// staged words of a code row of L positions (32 a word)
FGDP_HD int sweep_row_words(int L) { return (L + 31) >> 5; }

// whether a launch stages its lanes' codes: while the rows of a block's
// SWEEP_GROUPS groups fit in a block's default 48 KB of shared memory
// (L up to 12,288); longer rows are read where they lie
#define SWEEP_GROUPS 8   // sweep lanes (groups) a block
FGDP_HD bool sweep_staged(int L) {
  return (long long)SWEEP_GROUPS * sweep_row_words(L) * sizeof(LcpWord) <=
         48 * 1024;
}

// The lane's read: its staged words (STAGED, the group's buffer) or its
// int32 row where it lies.
template <bool STAGED>
struct SweepCodes {
  const LcpWord* rw;   // the staged row (STAGED)
  const int* row;      // codes + rid L
  int L, nw;

  // seed_read_at's value, but a code below 0 as 0 when staged (every use
  // tests "< 4" or clamps to 0..3)
  FGDP_HD int at(int p) const {
    if (p < 0 || p >= L) return 4;
    if (!STAGED) return fgdp_ld(row + p);
    const LcpWord v = rw[p >> 5];
    const int sh = 2 * (p & 31);
    const int code = (int)((v.c >> sh) & 3u);
    return ((v.n >> sh) & 1u) ? (code ? 4 : 0) : code;
  }

  FGDP_HD LcpWord word(int w) const {
    return (w >= 0 && w < nw) ? rw[w] : LcpWord{0, 0};
  }

  // The read's codes at [start, start + 64) (slot i = position start + i):
  // c the 2-bit codes, bad the slots that read 4 (outside [0, len), or an
  // N: a code outside [0, 4)). A position at or past L but below len
  // reads code 0, as the zero padding of pack_reads' words does.
  FGDP_HD void window(int len, int start, lcp_u64 c[2],
                      lcp_u64 bad[2]) const {
    if (STAGED) {
      const int w0 = start >> 5, sh = 2 * (start & 31);
      const LcpWord a = word(w0), b = word(w0 + 1), d = word(w0 + 2);
      lcp_u64 out[2];
      lcp_slots_outside((long long)start, len, out);
      c[0] = lcp_funnel(a.c, b.c, sh);
      c[1] = lcp_funnel(b.c, d.c, sh);
      bad[0] = lcp_funnel(a.n, b.n, sh) | out[0];
      bad[1] = lcp_funnel(b.n, d.n, sh) | out[1];
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lcp_u64 ch = 0, bh = 0;
#pragma unroll 16
      for (int i = 0; i < 32; ++i) {
        const long long p = (long long)start + 32 * h + i;
        int code = 0, nb = 0;
        if (p < 0 || p >= len) {
          nb = 1;
        } else if (p < L) {
          const int v = fgdp_ld(row + p);
          if (v < 0 || v >= 4)
            nb = 1;
          else
            code = v;
        }
        ch |= (lcp_u64)code << (2 * i);
        bh |= (lcp_u64)nb << (2 * i);
      }
      c[h] = ch;
      bad[h] = bh;
    }
  }
};

// word w0 + g of the packed reference for group lane g < 5 (the five
// words of a 64-slot text window, one a lane), clamped to the table as
// lcp_text_window's loads are
struct SweepTextWord {
  const long long* words;
  long long nwords, w0;
  FGDP_HD int operator()(int g) const {
    if (g >= 5) return 0;
    const long long w = fm_clampll(w0 + g, nwords - 1);
#ifdef __CUDA_ARCH__
    return (int)(unsigned)__ldg(words + w);
#else
    return (int)(unsigned)words[w];
#endif
  }
};

// lcp_text_window by a group: lanes 0-4 load a word each, every lane
// gathers the five by shuffles
template <class Group>
FGDP_HD void sweep_text_window(const Group& grp, const long long* words,
                               long long nwords, int start, lcp_u64 t[2]) {
  const auto v = grp.each(SweepTextWord{words, nwords,
                                        (long long)(start >> 4)});
  lcp_u64 x[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) x[k] = (unsigned)grp.get(v, k);
  lcp_text_slots(x, start, t);
}

// how an anchor ends (Group::note: the host twin counts them for the
// tests, the card's group ignores them): the walk's mismatch, read N and
// read end; the occ steps' read end, N and death at their first and
// second character; a lane that takes neither branch
enum {
  SWEEP_W_MIS, SWEEP_W_AMB, SWEEP_W_END, SWEEP_OFF0, SWEEP_AMB0,
  SWEEP_DIE0, SWEEP_OFF1, SWEEP_AMB1, SWEEP_DIE1, SWEEP_NEITHER,
  SWEEP_EXITS
};

// a lane's push counters and flags between steps (the same in every
// lane of its group; ints, which stay in registers: a struct of two
// bools went to the stack frame)
struct SweepFwdLane {
  int lane;
  int cur_np, ecount;
  int povf, eovf;
};

// one masked-on push with both caps; the group's lead lane writes it
template <class Group>
FGDP_HD void sweep_push(const SweepFwdArgs& A, const Group& grp,
                        SweepFwdLane& st, int m, int n, int k, int s) {
  if (st.cur_np < A.prev_cap) {
    if (st.ecount < A.E) {
      if (grp.lead()) {
        const long long at = (long long)st.lane * A.E + st.ecount;
        A.em[at] = m;
        A.en[at] = n;
        A.ek[at] = k;
        A.es[at] = s;
      }
      ++st.ecount;
    } else {
      st.eovf = 1;
    }
  } else {
    st.povf = 1;
  }
  st.cur_np = fgdp_min(st.cur_np + 1, A.prev_cap);
}

// One sweep lane by its group `grp`; `buf` is the group's staged row
// (STAGED: sweep_row_words(L) words) or unused.
template <bool RESTART, bool WALK, bool STAGED, class Group>
FGDP_HD void sweep_fwd_lane(const SweepFwdArgs& A, int lane,
                            const Group& grp, LcpWord* buf) {
  const int rid = fgdp_ld(A.rid + lane);
  const int len = fgdp_ld(A.lens + rid);
  const int mi = fgdp_ld(A.min_intv + lane);
  const int* row = A.codes + (long long)rid * A.L;
  SweepFwdLane st{lane, 0, 0, 0, 0};
  int x = fgdp_ld(A.x0 + lane), n = 0, k = 0, l = 0, s = 0;
  bool started = false, done = !A.active[lane];
  // a lane reads no position before x0 (x, n and j only grow), so the
  // words before x0's are not staged
  if (STAGED) grp.stage(buf, row, A.L, fgdp_max(x, 0) >> 5);
  const SweepCodes<STAGED> q{buf, row, A.L, sweep_row_words(A.L)};
  // the work counters in 32 bits (in 64, K2's staged kernel spilled a
  // register)
  int gb = 0, gsteps = 0, steps = 0;
  while (!done && (started || x < len)) {
    ++steps;
    // ---- restart: a lane with no anchor in progress ----
    if (!started) {
      const int a0 = q.at(x);
      if (a0 >= 4) {
        ++x;
        if (!RESTART) done = true;
        continue;
      }
      fm_init_interval(A.fm, a0, k, l, s);
      n = x;
      st.cur_np = 0;
      started = true;
    }
    const int j = n + 1, j1 = j + 1;
    // ---- text walk (s == 1) ----
    bool w_stop = false, w_amb = false, w_mis = false;
    int jd = j, n2 = n;
    if (WALK && s == 1) {
      // the SA entry: one address, loaded by every lane at once
      const int pos = fm_sa_lookup(A.fm, k);
      const int tstart = pos + (j - x);
      lcp_u64 rc[2], rbad[2], tc[2], tout[2], bad[2];
      q.window(len, j, rc, rbad);
      sweep_text_window(grp, A.words, A.nwords, tstart, tc);
      lcp_slots_outside((long long)tstart, A.l2ref, tout);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const lcp_u64 d = rc[h] ^ tc[h];
        bad[h] = ((d | (d >> 1)) & LCP_EVEN) | rbad[h] | tout[h];
      }
      gb += 4 + 40;
      gsteps += 2;
      int d = SWEEP_WALK_T;
      bool rb_bad = false;
      if (bad[0] | bad[1]) {
        const bool h = bad[0] == 0;
        const int bit = sweep_low_bit(h ? bad[1] : bad[0]);
        d = (h ? 32 : 0) + (bit >> 1);
        rb_bad = (((h ? rbad[1] : rbad[0]) >> bit) & 1u) != 0;
      }
      jd = j + d;
      n2 = jd - 1;
      w_stop = d < SWEEP_WALK_T;
      const bool w_end = w_stop && jd >= len;
      w_amb = w_stop && !w_end && rb_bad;
      w_mis = w_stop && !w_end && !w_amb;
      if (w_mis) sweep_push(A, grp, st, x, n2, k, s);
    } else if (s <= 1) {
      // neither branch: the torch-op loop would step this lane forever
      st.eovf = 1;
      grp.note(SWEEP_NEITHER);
      break;
    }
    // ---- occ branch (s > 1): two steps from one pair of rows ----
    bool off0 = false, amb0 = false, die0 = false;
    bool off1 = false, amb1 = false, die1 = false;
    int kB = k, lB = l, sB = s, nB = n2;
    if (s > 1) {
      off0 = j >= len;
      const int a = off0 ? 4 : q.at(j);
      amb0 = !off0 && a >= 4;
      if (!off0 && !amb0) {
        const int b = q.at(j1);
        int k1, l1, s1, k2, l2, s2;
        fm_forward_extend2_group(A.fm, grp, k, l, s, a, b, k1, l1, s1, k2,
                                 l2, s2);
        gb += 192;
        ++gsteps;
        if (s1 != s) sweep_push(A, grp, st, x, n, k, s);
        die0 = s1 < mi;
        if (!die0) {
          kB = k1;
          lB = l1;
          sB = s1;
          nB = j;
          off1 = j1 >= len;
          amb1 = !off1 && b >= 4;
          if (!off1 && !amb1) {
            if (s2 != s1) sweep_push(A, grp, st, x, j, k1, s1);
            die1 = s2 < mi;
            if (!die1) {
              kB = k2;
              lB = l2;
              sB = s2;
              nB = j1;
            }
          }
        }
      }
    }
    // ---- anchor end: final push, restart at next_x ----
    const bool ended = off0 || amb0 || die0 || off1 || amb1 || die1 ||
                       w_stop;
    // the torch-op loop's chain of wheres, later ones winning
    int nxt = len;   // the walk ran off the read
    if (w_amb) nxt = jd + 1;
    if (w_mis) nxt = jd;
    if (off1) nxt = j1;
    if (amb1) nxt = j1 + 1;
    if (die1) nxt = j1;
    if (off0) nxt = j;
    if (amb0) nxt = j + 1;
    if (die0) nxt = j;
    if (ended && sB >= mi) sweep_push(A, grp, st, x, nB, kB, sB);
    if (ended) {
      grp.note(w_mis   ? SWEEP_W_MIS
               : w_amb ? SWEEP_W_AMB
               : w_stop ? SWEEP_W_END
               : off0  ? SWEEP_OFF0
               : amb0  ? SWEEP_AMB0
               : die0  ? SWEEP_DIE0
               : off1  ? SWEEP_OFF1
               : amb1  ? SWEEP_AMB1
                       : SWEEP_DIE1);
      if (RESTART)
        x = nxt;
      else
        done = true;
    }
    n = nB;
    k = kB;
    l = lB;
    s = sB;
    started = !ended;
  }
  if (grp.lead()) {
    A.ecount[lane] = st.ecount;
    A.povf[lane] = st.povf != 0;
    A.eovf[lane] = st.eovf != 0;
    if (A.work != nullptr) {
      seed_work_add(A.work, gb);
      seed_work_max(A.work + 1, gsteps);
      seed_work_add(A.work + 2, steps);
      seed_work_max(A.work + 3, steps);
    }
  }
}
