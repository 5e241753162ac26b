// Banded extension Smith-Waterman (bwa ksw_extend2) for ONE job, its band
// columns spread over lanes L: the logic of the sw_extend kernel
// (sw_extend.cu), where L is a warp, also built on the host by
// host_twin.cc with one serial lane for the CPU tests.
//
// A transcription of the row loop of ops/sw.py (sw_extend_plain), itself
// the contract of the TPU kernel fgdp_tpu/ops/sw_pallas.py (_kernel), row
// by row as that code computes it over the whole band state: M, E, H and
// the new E per column, the in-row F (gap-in-target) term as the
// exclusive prefix max of v[j] = t_ins[j] + j e_ins, the row max and its
// last argmax, the band state shifted by one column, max_ie, gscore,
// max_off, z-drop and the new beg/end from the nonzero columns. The
// arithmetic is int32 and every reduction is a max or a min, so the order
// in which the lanes combine gives the same values.
//
// Layout: lane l holds band columns l*K .. l*K + K - 1 of eh_h/eh_e (the
// QP + 2 columns of the plain version, padded to K * width; the padding
// is never in the band and never read into a result) and its query codes,
// in registers for the whole job. The target is read 'width' codes at a
// time, one per lane, and broadcast to the warp row by row.
#pragma once

#include "common.cuh"

struct SWParamsC {
  int o_del, e_del, o_ins, e_ins, zdrop, end_bonus, mat_max, mat_mis,
      mat_amb;
};

// columns of a lane: K <= SW_MAX_K on the card (32 lanes: QP <= 254),
// SW_HOST_COLS for the host twin's single lane
#define SW_MAX_K 8
#define SW_HOST_COLS 256
// out: score, qle, tle, gtle, gscore, max_off, and the rows computed
#define SW_OUTS 7

// q: the job's query codes [QP]; t: its target codes [TP]. Returns the
// number of DP cells computed (the sum of end - beg over non-empty rows)
// and fills out[SW_OUTS]; every lane gets the same values.
template <int K, class Lanes>
FGDP_HD long long sw_extend_job(const int* q, const int* t, int QP, int TP,
                                int qlen, int tlen, int h0, int w,
                                const SWParamsC& p, const Lanes& L,
                                int* out) {
  const int NEG_INF = -(1 << 30);
  const int lane = L.lane(), W = L.width();
  const int j0 = lane * K;   // this lane's first column
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  int mx = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0, rows = 0;
  long long cells = 0;
  const int T = fgdp_min(TP, tlen);
  if (qlen > 0 && T > 0) {
    const int max_ins =
        fgdp_floordiv(qlen * p.mat_max + p.end_bonus - p.o_ins, p.e_ins) + 1;
    const int max_del =
        fgdp_floordiv(qlen * p.mat_max + p.end_bonus - p.o_del, p.e_del) + 1;
    const int weff = fgdp_min(w, fgdp_max(fgdp_min(max_ins, max_del), 1));

    // first row: eh_h[0] = h0, eh_h[j >= 1] = max(h0 - oe_ins - (j-1)e, 0)
    int eh[K], ee[K], qc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      eh[k] = j == 0 ? h0
                     : (j <= qlen ? fgdp_max(h0 - oe_ins - (j - 1) * p.e_ins, 0)
                                  : 0);
      ee[k] = 0;
      qc[k] = j < QP ? fgdp_min(fgdp_max(q[j], 0), 4) : 4;
    }

    int beg_s = 0, end_s = qlen, tcache = 0;
    for (int i = 0; i < T; ++i) {
      if (i % W == 0) tcache = i + lane < T ? t[i + lane] : 0;
      const int tb = L.shfl(tcache, i % W);
      const int beg = fgdp_max(beg_s, i - weff);
      const int end = fgdp_min(fgdp_min(end_s, i + weff + 1), qlen);
      const int h1_init =
          beg == 0 ? fgdp_max(h0 - (p.o_del + p.e_del * (i + 1)), 0) : 0;

      // M per column, and v's prefix max over the lane's columns before k
      int m[K], pre[K];
      int run = NEG_INF;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        const int sc = (tb >= 4 || qc[k] >= 4)
                           ? p.mat_amb
                           : (qc[k] == tb ? p.mat_max : -p.mat_mis);
        m[k] = eh[k] != 0 ? eh[k] + sc : 0;
        const bool in = j >= beg && j < end;
        const int v = (in ? fgdp_max(m[k] - oe_ins, 0) : NEG_INF) + j * p.e_ins;
        pre[k] = run;
        run = fgdp_max(run, v);
      }
      // inclusive scan of the lane totals; the lanes before this one
      // carry their max in
      int scan = run;
      for (int d = 1; d < W; d <<= 1) {
        const int y = L.shfl_up(scan, d);
        if (lane >= d) scan = fgdp_max(scan, y);
      }
      int carry = L.shfl_up(scan, 1);
      if (lane == 0) carry = NEG_INF;

      int hk[K], ek[K];
      int hloc = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        const bool in = j >= beg && j < end;
        const int f =
            fgdp_max(fgdp_max(carry, pre[k]) - (j - 1) * p.e_ins, 0);
        hk[k] = in ? fgdp_max(fgdp_max(m[k], ee[k]), f) : 0;
        ek[k] = in ? fgdp_max(fgdp_max(m[k] - oe_del, 0), ee[k] - p.e_del) : 0;
        hloc = fgdp_max(hloc, hk[k]);
      }
      const int mrow = L.max(hloc);
      int mj = -1;   // last argmax of the row max
      if (mrow > 0) {
        int jloc = -1;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (hk[k] == mrow) jloc = j0 + k;
        mj = L.max(jloc);
      }

      // new eh_h[j] = H(i, j-1) for j in (beg, end], eh_h[beg] = h1_init;
      // new eh_e[j] for j in [beg, end), eh_e[end] = 0
      const int h_left = L.shfl_up(hk[K - 1], 1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        const int hs = k == 0 ? h_left : hk[k == 0 ? 0 : k - 1];
        eh[k] = j == beg ? h1_init : (j > beg && j <= end ? hs : eh[k]);
        ee[k] = j >= beg && j < end ? ek[k] : (j == end ? 0 : ee[k]);
      }
      int h1_last = h1_init;
      if (end > beg) {
        cells += end - beg;
        int hl = 0;   // new eh_h[end] = H(i, end-1)
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (j0 + k == end) hl = eh[k];
        h1_last = L.shfl(hl, end / K);
      }
      ++rows;

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
      if (died_zero || zdie) break;

      // the new band: first nonzero column in [beg, end) (else end), and
      // the last in [nbeg, end] (else nbeg - 1)
      int fb = end;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        if ((eh[k] != 0 || ee[k] != 0) && j >= beg && j < end)
          fb = fgdp_min(fb, j);
      }
      const int nbeg = L.min(fb);
      int lz = nbeg - 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        if ((eh[k] != 0 || ee[k] != 0) && j >= nbeg && j <= end) lz = j;
      }
      beg_s = nbeg;
      end_s = fgdp_min(L.max(lz) + 2, qlen);
    }
  }
  out[0] = mx;
  out[1] = max_j + 1;
  out[2] = max_i + 1;
  out[3] = max_ie + 1;
  out[4] = gscore;
  out[5] = max_off;
  out[6] = rows;
  return cells;
}
