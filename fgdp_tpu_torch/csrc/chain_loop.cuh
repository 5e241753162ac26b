// Chain-table construction for ONE read: the per-warp logic of the
// chain_loop kernel (chain_loop.cu), also built on the host by
// host_twin.cc (with a one-lane "warp") for the CPU tests.
//
// A transcription of the jnp chain loop of fgdp_tpu/align/chain.py
// (chain_seeds body, itself the reference's mem_chain_seeds_new,
// src/bwamem.cpp:1163-1237), the contract of the TPU kernel
// fgdp_tpu/ops/chain_pallas.py (_kernel). Seeds are inserted in slot
// order; for each, the chain with the largest pos <= rbeg (ties to the
// latest slot) either contains it (dropped), grows by it, or a new
// chain opens. Integer arithmetic only, with the same compares in the
// same order, so the result is bit-equal.
#pragma once

#include "common.cuh"

// field rows of the per-read chain table (each C long)
enum {
  CH_POS, CH_CRID, CH_FQ, CH_FR, CH_LQ, CH_LR, CH_LL, CH_NS, CH_WQ, CH_WR,
  CH_QEND, CH_REND, CH_NFIELDS
};
#define CH_NOUT 10   // pos..wr are returned; qend/rend are loop-internal

struct ChainArgs {
  const int* qbeg;            // [B, P]
  const int* rbeg;
  const int* slen;
  const int* rid;
  const unsigned char* valid;  // [B, P] bool
  const unsigned char* ovf_in; // [B] bool
  int B, P, C, l_pac, w, max_chain_gap;
  int* out;                   // [CH_NOUT, B, C]
  int* n_out;                 // [B]
  unsigned char* ovf_out;     // [B]
  int* chain_of;              // [B, P]
};

// Lanes: lane(), width(), max(v), any(v), sync(). Slots c = lane(),
// lane()+width(), ... belong to one lane; every lane computes the same
// decisions from the reduced values, and lane 0 writes the table.
template <class Lanes>
FGDP_HD void chain_read(const ChainArgs& a, int b, int* st, Lanes& L) {
  const int C = a.C, P = a.P;
  const long long rowP = (long long)b * P;
  const int lane = L.lane(), W = L.width();
  for (int c = lane; c < C; c += W)
    for (int f = 0; f < CH_NFIELDS; ++f) st[f * C + c] = 0;

  // each read loops only to its own last valid seed slot
  int tl = 0;
  for (int t = lane; t < P; t += W)
    if (a.valid[rowP + t]) tl = t + 1;
  tl = L.max(tl);
  for (int t = tl + lane; t < P; t += W) a.chain_of[rowP + t] = -1;
  L.sync();

  int n = 0;
  bool ovf = a.ovf_in[b] != 0;
  for (int t = 0; t < tl; ++t) {
    if (!a.valid[rowP + t]) {
      if (lane == 0) a.chain_of[rowP + t] = -1;
      continue;
    }
    const int qb = a.qbeg[rowP + t], rb = a.rbeg[rowP + t];
    const int ln = a.slen[rowP + t], rd = a.rid[rowP + t];
    // closest chain with pos <= rb (kb_intervalp lower); tie -> latest
    int mp = -1;
    bool el = false;
    for (int c = lane; c < n; c += W) {
      const int p = st[CH_POS * C + c];
      if (p <= rb) {
        el = true;
        if (p > mp) mp = p;
      }
    }
    mp = L.max(mp);
    const bool has_lo = L.any(el);
    int lc = 0;
    for (int c = lane; c < n; c += W) {
      const int p = st[CH_POS * C + c];
      if (p <= rb && p == mp) lc = c;
    }
    const int lo = L.max(lc);

    const int* s = st + lo;
    const int g_lq = s[CH_LQ * C], g_lr = s[CH_LR * C], g_ll = s[CH_LL * C];
    const int g_fq = s[CH_FQ * C], g_fr = s[CH_FR * C];
    const int g_qend = s[CH_QEND * C], g_rend = s[CH_REND * C];
    const int g_ns = s[CH_NS * C], g_wq = s[CH_WQ * C], g_wr = s[CH_WR * C];
    const bool same_rid = s[CH_CRID * C] == rd;
    const bool contained = (qb >= g_fq) && (qb + ln <= g_lq + g_ll) &&
                           (rb >= g_fr) && (rb + ln <= g_lr + g_ll);
    const bool diff_strand =
        ((g_lr < a.l_pac) || (g_fr < a.l_pac)) && (rb >= a.l_pac);
    const int x = qb - g_lq, y = rb - g_lr;
    const bool growable = (y >= 0) && (x - y <= a.w) && (y - x <= a.w) &&
                          (x - g_ll < a.max_chain_gap) &&
                          (y - g_ll < a.max_chain_gap);
    const bool merged_contained = has_lo && same_rid && contained;
    const bool appended =
        has_lo && same_rid && !contained && !diff_strand && growable;
    const bool new_chain = !(merged_contained || appended);
    const bool room = n < C;
    L.sync();   // every lane has read slot lo before lane 0 writes

    if (lane == 0) {
      if (appended) {
        const int dq = qb >= g_qend ? ln : fgdp_max(qb + ln - g_qend, 0);
        const int dr = rb >= g_rend ? ln : fgdp_max(rb + ln - g_rend, 0);
        int* d = st + lo;
        d[CH_LQ * C] = qb;
        d[CH_LR * C] = rb;
        d[CH_LL * C] = ln;
        d[CH_NS * C] = g_ns + 1;
        d[CH_WQ * C] = g_wq + dq;
        d[CH_WR * C] = g_wr + dr;
        d[CH_QEND * C] = fgdp_max(g_qend, qb + ln);
        d[CH_REND * C] = fgdp_max(g_rend, rb + ln);
      }
      if (new_chain && room) {
        int* d = st + n;
        d[CH_POS * C] = rb;
        d[CH_CRID * C] = rd;
        d[CH_FQ * C] = qb;
        d[CH_FR * C] = rb;
        d[CH_LQ * C] = qb;
        d[CH_LR * C] = rb;
        d[CH_LL * C] = ln;
        d[CH_NS * C] = 1;
        d[CH_WQ * C] = ln;
        d[CH_WR * C] = ln;
        d[CH_QEND * C] = qb + ln;
        d[CH_REND * C] = rb + ln;
      }
      int cid = appended ? lo : ((new_chain && room) ? n : -1);
      a.chain_of[rowP + t] = cid;   // merged_contained: -1 (dropped)
    }
    ovf = ovf || (new_chain && !room);
    n += (new_chain && room) ? 1 : 0;
    L.sync();
  }

  const long long BC = (long long)a.B * C;
  for (int c = lane; c < C; c += W)
    for (int f = 0; f < CH_NOUT; ++f)
      a.out[f * BC + (long long)b * C + c] = st[f * C + c];
  if (lane == 0) {
    a.n_out[b] = n;
    a.ovf_out[b] = ovf ? 1 : 0;
  }
}
