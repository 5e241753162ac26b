// Banded extension Smith-Waterman (bwa ksw_extend2) for ONE job: the
// per-thread logic of the sw_extend kernel (sw_extend.cu), also built on
// the host by host_twin.cc for the CPU tests.
//
// A transcription of the row loop of ops/sw.py (sw_extend), itself the
// contract of the TPU kernel fgdp_tpu/ops/sw_pallas.py (_kernel). Every
// per-row quantity is computed as that code computes it: beg, end, the
// row max and its last argmax, max_ie, gscore, max_off, z-drop, and the
// new beg/end scan over nonzero H/E. The in-row F (gap-in-target)
// recurrence is a running max carried along the row; the TPU kernel
// takes it as a log-doubling cummax. The integer max is exact, so both
// give the same values.
#pragma once

#include "common.cuh"

struct SWParamsC {
  int o_del, e_del, o_ins, e_ins, zdrop, end_bonus, mat_max, mat_mis,
      mat_amb;
};

// q: the job's query codes [QP]; t: its target codes [TP]. eh_h/eh_e:
// the job's band state, QP+2 entries `stride` apart (the kernel lays
// them out job-minor so a warp's accesses coalesce). out: score, qle,
// tle, gtle, gscore, max_off. Returns the number of DP cells computed.
FGDP_HD long long sw_extend_job(const int* q, const int* t, int QP, int TP,
                                int qlen, int tlen, int h0, int w,
                                const SWParamsC& p, int* eh_h, int* eh_e,
                                long long stride, int* out) {
  const int NEG_INF = -(1 << 30);
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int max_ins =
      fgdp_floordiv(qlen * p.mat_max + p.end_bonus - p.o_ins, p.e_ins) + 1;
  const int max_del =
      fgdp_floordiv(qlen * p.mat_max + p.end_bonus - p.o_del, p.e_del) + 1;
  const int weff = fgdp_min(w, fgdp_max(fgdp_min(max_ins, max_del), 1));

  // first row: eh_h[0]=h0, eh_h[j>=1] = max(h0 - oe_ins - (j-1)e_ins, 0)
  for (int jr = 0; jr < QP + 2; ++jr) {
    int h = jr == 0 ? h0
                    : (jr <= qlen
                           ? fgdp_max(h0 - oe_ins - (jr - 1) * p.e_ins, 0)
                           : 0);
    eh_h[jr * stride] = h;
    eh_e[jr * stride] = 0;
  }

  int beg_s = 0, end_s = qlen, mx = h0;
  int max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
  bool dead = qlen <= 0 || tlen <= 0;
  long long cells = 0;
  for (int i = 0; i < TP && i < tlen && !dead; ++i) {
    const int beg = fgdp_max(beg_s, i - weff);
    const int end = fgdp_min(fgdp_min(end_s, i + weff + 1), qlen);
    const int h1_init =
        beg == 0 ? fgdp_max(h0 - (p.o_del + p.e_del * (i + 1)), 0) : 0;
    const int tb = t[i];

    int G = NEG_INF;   // max over in-band k < j of max(M_k - oe_ins, 0) + k e
    int h1 = h1_init;  // H(i, j-1)
    int mrow = 0, mj = -1, first_nz = -1, last_nz = -1;
    for (int j = beg; j < end; ++j) {
      const int hprev = eh_h[j * stride];     // H(i-1, j-1)
      const int e = eh_e[j * stride];         // E(i, j)
      int qc = q[j];
      qc = qc < 0 ? 0 : (qc > 4 ? 4 : qc);
      const int sc = (tb >= 4 || qc >= 4) ? p.mat_amb
                                          : (qc == tb ? p.mat_max : -p.mat_mis);
      const int m = hprev != 0 ? hprev + sc : 0;
      const int f = fgdp_max(G - (j - 1) * p.e_ins, 0);
      G = fgdp_max(G, fgdp_max(m - oe_ins, 0) + j * p.e_ins);
      const int h = fgdp_max(fgdp_max(m, e), f);
      if (h > 0 && h >= mrow) {   // row max, last argmax
        mrow = h;
        mj = j;
      }
      const int ne = fgdp_max(fgdp_max(m - oe_del, 0), e - p.e_del);
      eh_h[j * stride] = h1;       // new eh_h[j] = H(i, j-1); [beg] = h1_init
      eh_e[j * stride] = ne;
      if (h1 != 0 || ne != 0) {
        if (first_nz < 0) first_nz = j;
        last_nz = j;
      }
      h1 = h;
    }
    int h1_last, nbeg, last;
    if (end > beg) {
      cells += end - beg;
      eh_h[end * stride] = h1;     // H(i, end-1)
      eh_e[end * stride] = 0;
      h1_last = h1;
      nbeg = first_nz >= 0 ? first_nz : end;
      last = h1 != 0 ? end : (last_nz >= 0 ? last_nz : nbeg - 1);
    } else {
      // empty band: only eh_h[beg] and eh_e[end] change
      if (beg >= 0 && beg < QP + 2) eh_h[beg * stride] = h1_init;
      const bool end_in = end >= 0 && end < QP + 2;
      if (end_in) eh_e[end * stride] = 0;
      h1_last = h1_init;
      nbeg = end;
      last = (end_in && (eh_h[end * stride] != 0 || eh_e[end * stride] != 0))
                 ? end
                 : end - 1;
    }

    if (end == qlen) {   // ties move max_ie forward
      if (h1_last >= gscore) max_ie = i;
      if (h1_last > gscore) gscore = h1_last;
    }
    const bool died_zero = mrow == 0;
    const bool improved = !died_zero && mrow > mx;
    const int di = i - max_i, dj = mj - max_j;
    const int ddiag = di > dj ? di - dj : dj - di;
    const int epen = di > dj ? p.e_del : p.e_ins;
    const bool zdie = !died_zero && !improved && p.zdrop > 0 &&
                      (mx - mrow - ddiag * epen > p.zdrop);
    if (improved) {
      const int off = mj - i < 0 ? i - mj : mj - i;
      max_off = fgdp_max(max_off, off);
      mx = mrow;
      max_i = i;
      max_j = mj;
    }
    const bool alive = !died_zero && !zdie;
    beg_s = alive ? nbeg : beg;
    end_s = alive ? fgdp_min(last + 2, qlen) : end;
    dead = died_zero || zdie;
  }
  out[0] = mx;
  out[1] = max_j + 1;
  out[2] = max_i + 1;
  out[3] = max_ie + 1;
  out[4] = gscore;
  out[5] = max_off;
  return cells;
}
