// Chain-table construction for ONE read: the per-warp logic of the
// chain_loop kernel (chain_loop.cu), also built on the host by
// host_twin.cc for the CPU tests.
//
// A transcription of the jnp chain loop of fgdp_tpu/align/chain.py
// (chain_seeds body, itself the reference's mem_chain_seeds_new,
// src/bwamem.cpp:1163-1237), the contract of the TPU kernel
// fgdp_tpu/ops/chain_pallas.py (_kernel). Seeds are inserted in slot
// order; for each, the chain with the largest pos <= rbeg (ties to the
// latest slot) either contains it (dropped), grows by it, or a new
// chain opens. Integer arithmetic only, with the same compares in the
// same order, so the result is bit-equal.
//
// Two layouts of the same logic:
//
// - chain_read_regs<K>, the main path (C <= 32 CH_MAX_K): one warp per
//   read, pos in registers (slot c in lane c % 32, register c / 32,
//   K = ceil(C / 32)), the other fields in the warp's table in shared
//   memory, one 48-byte row a slot. The seeds stream in 32 slots at a
//   time, one slot a lane, the next chunk's loads in flight; the chunk's
//   valid flags become one ballot word whose set bits are the steps, and
//   a step takes its seed by shuffle, a step ahead. The search for step
//   t + 1 (a warp max over pos, then over the ties' slots) runs on the
//   table as it stood before step t, beside step t's decision: a chain's
//   pos is written only when the chain opens, and a new chain takes
//   slot n, the highest, so step t's new chain (pos rb_t) corrects the
//   search with one compare: if rb_t <= rb_{t+1} it is eligible, and if
//   rb_t is at least the searched maximum it is the latest of the ties.
//   Slot lo's row is read by every lane with three 16-byte loads, before
//   step t's write lands; if step t wrote slot lo, its values come
//   straight from step t. Every lane decides alike (branch-free); the
//   lead lane writes the row and lane t % 32 keeps step t's chain id,
//   stored 32 at a time.
// - chain_read_wide, for C above: the whole table in shared memory, two
//   warp reductions a step, lane 0 writing the table.
#pragma once

#include "common.cuh"

// field rows of the per-read chain table (each C long)
enum {
  CH_POS, CH_CRID, CH_FQ, CH_FR, CH_LQ, CH_LR, CH_LL, CH_NS, CH_WQ, CH_WR,
  CH_QEND, CH_REND, CH_NFIELDS
};
#define CH_NOUT 10   // pos..wr are returned; qend/rend are loop-internal

// widest register path: K <= CH_MAX_K registers a lane, C <= 32 K
#define CH_MAX_K 8

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

// ------------------------------------------------------- register path

// The read's seed slots below tl, 32 at a time: lane l holds slot
// base + l of the chunk being stepped (cur) and of the next one (nxt),
// whose loads are in flight; `mask` holds the cur slots not yet taken.
template <class L>
struct ChainStream {
  using I = typename L::I;
  enum { V, QB, RB, LN, RD, NCOL };
  const ChainArgs& a;
  const long long row;
  const int tl;
  const L& lanes;
  int base = 0;
  unsigned mask;
  I cur[NCOL], nxt[NCOL];

  FGDP_HD ChainStream(const ChainArgs& a_, long long row_, int tl_,
                      const L& lanes_)
      : a(a_), row(row_), tl(tl_), lanes(lanes_) {
    load(0, cur);
    load(32, nxt);
    mask = lanes.ballot(cur[V] != 0);
  }

  FGDP_HD void load(int b0, I (&d)[NCOL]) const {
    const I t = lanes.lane() + b0;
    const auto ok = t < tl;
    d[V] = lanes.load_u8(a.valid + row, t, ok);
    d[QB] = lanes.load(a.qbeg + row, t, ok, 0);
    d[RB] = lanes.load(a.rbeg + row, t, ok, 0);
    d[LN] = lanes.load(a.slen + row, t, ok, 0);
    d[RD] = lanes.load(a.rid + row, t, ok, 0);
  }

  // the next valid slot t and its qbeg, rbeg, slen, rid; false past tl
  FGDP_HD bool next(int& t, int (&s)[4]) {
    while (mask == 0) {
      if (base + 32 >= tl) return false;
      base += 32;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) cur[c] = nxt[c];
      load(base + 32, nxt);
      mask = lanes.ballot(cur[V] != 0);
    }
    const int l = fgdp_ctz(mask);
    mask &= mask - 1;
    t = base + l;
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = lanes.shfl(cur[QB + c], l);
    return true;
  }
};

// Largest pos <= rb among slots below n (-1 if none is larger), the
// latest slot holding it among those (0 if none), whether any is.
template <int K, class L>
FGDP_HD void chain_search(const typename L::I (&pos)[K], int n, int rb,
                          const L& lanes, int& mp, int& lo, bool& has) {
  using I = typename L::I;
  const I lane = lanes.lane();
  I best = I(-1), any = I(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const auto e = ((lane + 32 * k) < n) & (pos[k] <= rb);
    best = lanes.sel(e & (best < pos[k]), pos[k], best);
    any = any | e;
  }
  mp = lanes.max(best);
  has = lanes.ballot(any != 0) != 0;
  I lc = I(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const I c = lane + 32 * k;
    lc = lanes.sel((c < n) & (pos[k] <= rb) & (pos[k] == mp), c, lc);
  }
  lo = lanes.max(lc);
}

// four ints at p (16-byte aligned): one vector access on the card
FGDP_HD void ch_load4(const int* p, int* d) {
#ifdef __CUDA_ARCH__
  const int4 v = *reinterpret_cast<const int4*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
#else
  for (int i = 0; i < 4; ++i) d[i] = p[i];
#endif
}

FGDP_HD void ch_store4(int* p, const int* s) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(p) = make_int4(s[0], s[1], s[2], s[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = s[i];
#endif
}

// A step's write of slot record `rec` at d: all 12 fields of a new chain
// (`opened`), lq..rend of an append (pk), by the lead lane; then every
// lane may read the table.
template <class L>
FGDP_HD void chain_write(int* d, const int* rec, bool opened, bool pk,
                         const L& lanes) {
  const bool lead = lanes.lead();
  if (lead && opened) ch_store4(d, rec);
  if (lead && pk) {
    ch_store4(d + 4, rec + 4);
    ch_store4(d + 8, rec + 8);
  }
  lanes.sync();
}

// One read on the register path (K = ceil(C / 32) of its launch). pos
// lives in registers; `tb` is the warp's table in shared memory, slot c
// at tb + CH_NFIELDS c (16-byte aligned), all 12 fields, written by the
// lead lane and read by every lane at the same address.
template <int K, class L>
FGDP_HD void chain_read_regs(const ChainArgs& a, int b, int* tb,
                             const L& lanes) {
  using I = typename L::I;
  const int C = a.C, P = a.P;
  const int l_pac = a.l_pac, w = a.w, gap = a.max_chain_gap;
  const long long row = (long long)b * P;
  const I lane = lanes.lane();

  // each read steps only to its own last valid slot
  I tl_l = I(0);
  for (int t0 = 0; t0 < P; t0 += 32) {
    const I t = lane + t0;
    tl_l = lanes.sel(lanes.load_u8(a.valid + row, t, t < P) != 0, t + 1,
                     tl_l);
  }
  const int tl = lanes.max(tl_l);

  I pos[K];
#pragma unroll
  for (int k = 0; k < K; ++k) pos[k] = I(0);
  for (int i0 = 0; i0 < CH_NFIELDS * C; i0 += 32)
    lanes.store_if(tb, lane + i0, I(0), lane + i0 < CH_NFIELDS * C);
  lanes.sync();

  ChainStream<L> seeds(a, row, tl, lanes);
  int n = 0;
  bool ovf = a.ovf_in[b] != 0;
  I cof = I(-1);   // chain ids of step chunk oc, step t in lane t % 32
  int oc = 0;
  // the previous step's write, not yet in the table: the record `rec`
  // of slot pw (a new chain when `opened`, else an append when pk)
  bool pk = false, opened = false;
  int pw = 0, prb = 0;
  int rec[CH_NFIELDS];
#pragma unroll
  for (int f = 0; f < CH_NFIELDS; ++f) rec[f] = 0;
  // the search for the current step, on the table before the previous
  // step (the table is empty before the first)
  int s_mp = -1, s_lo = 0;
  bool s_has = false;

  // the current step (t, sd: qbeg, rbeg, slen, rid) and the next one,
  // fetched a step ahead so that its search starts with the step
  int t = 0, sd[4] = {0, 0, 0, 0}, t1 = 0, sd1[4] = {0, 0, 0, 0};
  bool more = seeds.next(t, sd);
  bool more1 = seeds.next(t1, sd1);
  while (more) {
    const int qb = sd[0], rb = sd[1], ln = sd[2], rd = sd[3];
    while ((t >> 5) != oc) {
      lanes.store_if(a.chain_of + row, lane + 32 * oc, cof,
                     lane + 32 * oc < P);
      cof = I(-1);
      ++oc;
    }

    // slot s_lo before the previous step's write (where that step wrote
    // it, the values read are replaced below)
    int g[CH_NFIELDS];
    {
      const int* sl = tb + CH_NFIELDS * s_lo;
      ch_load4(sl, g);
      ch_load4(sl + 4, g + 4);
      ch_load4(sl + 8, g + 8);
    }
    // the previous step's write: into the table, and pos into its
    // owner lane's register
    chain_write(tb + CH_NFIELDS * pw, rec, opened, pk, lanes);
#pragma unroll
    for (int k = 0; k < K; ++k)
      pos[k] = lanes.sel((lane == (pw & 31)) & ((pw >> 5) == k) & opened,
                         rec[CH_POS], pos[k]);
    // the next step's search, on the table before this step
    int mp1, lo1;
    bool has1;
    chain_search<K>(pos, n, sd1[1], lanes, mp1, lo1, has1);

    // this step's slot lo: the search's, or the chain the previous step
    // opened (slot n then, the latest, so it wins a tie); slot lo's
    // values straight from the previous step where it wrote them. The
    // decision is warp-uniform and branch-free (& and |, not && and ||).
    const bool new_elig = opened & (prb <= rb);
    const bool has_lo = s_has | new_elig;
    const int lo = (new_elig & (prb >= s_mp)) ? pw : s_lo;
    const bool fresh = pk & (lo == pw);
#pragma unroll
    for (int f = CH_CRID; f < CH_NFIELDS; ++f)
      g[f] = (f <= CH_FR ? (fresh & opened) : fresh) ? rec[f] : g[f];

    const bool same_rid = g[CH_CRID] == rd;
    const bool contained = (qb >= g[CH_FQ]) &
                           (qb + ln <= g[CH_LQ] + g[CH_LL]) &
                           (rb >= g[CH_FR]) &
                           (rb + ln <= g[CH_LR] + g[CH_LL]);
    const bool diff_strand =
        ((g[CH_LR] < l_pac) | (g[CH_FR] < l_pac)) & (rb >= l_pac);
    const int x = qb - g[CH_LQ], y = rb - g[CH_LR];
    const bool growable = (y >= 0) & (x - y <= w) & (y - x <= w) &
                          (x - g[CH_LL] < gap) & (y - g[CH_LL] < gap);
    const bool merged_contained = has_lo & same_rid & contained;
    const bool appended =
        has_lo & same_rid & !contained & !diff_strand & growable;
    const bool new_chain = !(merged_contained | appended);
    const bool room = n < C;
    // merged_contained: -1 (dropped)
    const int cid = appended ? lo : ((new_chain & room) ? n : -1);
    cof = lanes.sel(lane == (t & 31), cid, cof);

    // this step's write: the whole record of slot lo (appended) or n
    const int dq = qb >= g[CH_QEND] ? ln : fgdp_max(qb + ln - g[CH_QEND], 0);
    const int dr = rb >= g[CH_REND] ? ln : fgdp_max(rb + ln - g[CH_REND], 0);
    rec[CH_POS] = rb;
    rec[CH_CRID] = rd;
    rec[CH_FQ] = qb;
    rec[CH_FR] = rb;
    rec[CH_LQ] = qb;
    rec[CH_LR] = rb;
    rec[CH_LL] = ln;
    rec[CH_NS] = appended ? g[CH_NS] + 1 : 1;
    rec[CH_WQ] = appended ? g[CH_WQ] + dq : ln;
    rec[CH_WR] = appended ? g[CH_WR] + dr : ln;
    rec[CH_QEND] = appended ? fgdp_max(g[CH_QEND], qb + ln) : qb + ln;
    rec[CH_REND] = appended ? fgdp_max(g[CH_REND], rb + ln) : rb + ln;
    opened = new_chain & room;
    pk = appended | opened;
    pw = appended ? lo : n;
    prb = rb;
    ovf = ovf | (new_chain & !room);
    n += opened ? 1 : 0;

    s_mp = mp1;
    s_lo = lo1;
    s_has = has1;
    t = t1;
#pragma unroll
    for (int c = 0; c < 4; ++c) sd[c] = sd1[c];
    more = more1;
    more1 = seeds.next(t1, sd1);   // false again once past tl
  }

  // the last step's write, the last chunks of chain ids, the table
  chain_write(tb + CH_NFIELDS * pw, rec, opened, pk, lanes);
  for (; 32 * oc < P; ++oc) {
    lanes.store_if(a.chain_of + row, lane + 32 * oc, cof,
                   lane + 32 * oc < P);
    cof = I(-1);
  }
  const long long BC = (long long)a.B * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const I c = lane + 32 * k;
    const auto ok = c < C;
#pragma unroll
    for (int f = 0; f < CH_NOUT; ++f)
      lanes.store_if(a.out + f * BC + (long long)b * C, c,
                     lanes.load(tb + f, c * CH_NFIELDS, ok, 0), ok);
  }
  // n and ovf are the same in every lane: one store of one value
  a.n_out[b] = n;
  a.ovf_out[b] = ovf ? 1 : 0;
}

// ----------------------------------------------------------- wide path

// Lanes: lane(), width(), max(v), any(v), sync(). Slots c = lane(),
// lane()+width(), ... belong to one lane; every lane computes the same
// decisions from the reduced values, and lane 0 writes the table.
template <class Lanes>
FGDP_HD void chain_read_wide(const ChainArgs& a, int b, int* st, Lanes& L) {
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
