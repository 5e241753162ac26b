// Host twin of the CUDA kernels, for the CPU tests only: g++ builds the
// kernels' own per-job (sw_extend.cuh, kswv.cuh), per-read
// (chain_loop.cuh, chain_flt.cuh, seed_strategy.cuh), per-pair
// (pairhmm.cuh) and per-element (vpu_ceiling.cuh) logic into a plain C
// library, run with one serial lane (the register paths of the chain
// loop, kswv and PairHMM, and the chain filter, with 32 lanes in
// lockstep; K3 with its group's 16 lanes in lockstep), the FM rank
// primitives (fm.cuh) one interval at a time, and the seeding wave machines (smem_lcp.cuh,
// k2_lcp.cuh) with every lane in one thread and the counts taken on the
// host step by step, the sweep's two phases (sweep_fwd.cuh,
// sweep_bwd.cuh) one lane after another (D9's lane as its group of 16
// lockstep lanes), so the logic can be
// held against the plain PyTorch versions where there is no nvcc. It
// builds with -ffp-contract=off, so that no multiply and add fuse into
// one rounding, as on the card. The port's CPU path never calls it; it
// runs the plain PyTorch versions.
#include <algorithm>
#include <array>
#include <cstddef>
#include <type_traits>
#include <vector>

// A warp's 32 lanes in lockstep, for the register paths: a lane value is
// an array of 32, every operation acts lane by lane, a rotation permutes
// the array, a reduction or a ballot reads all 32. Declared before the
// kernels' logic so that its operators and hmm_* overloads are the ones
// the logic finds.
template <class T>
struct Lane32 {
  T v[32];
  Lane32() {}
  Lane32(T s) {
    for (int i = 0; i < 32; ++i) v[i] = s;
  }
};

template <class T>
struct is_lane : std::false_type {};
template <class T>
struct is_lane<Lane32<T>> : std::true_type {};
template <class A, class B>
using if_lane = std::enable_if_t<is_lane<A>::value || is_lane<B>::value>;

template <class T>
const T& at(const Lane32<T>& a, int i) { return a.v[i]; }
template <class T, class = std::enable_if_t<!is_lane<T>::value>>
const T& at(const T& a, int) { return a; }

#define LANE_BINOP(OP)                                              \
  template <class A, class B, class = if_lane<A, B>>                \
  auto operator OP(const A& a, const B& b) {                        \
    Lane32<decltype(at(a, 0) OP at(b, 0))> r;                       \
    for (int i = 0; i < 32; ++i) r.v[i] = at(a, i) OP at(b, i);     \
    return r;                                                       \
  }
LANE_BINOP(+) LANE_BINOP(-) LANE_BINOP(*) LANE_BINOP(&) LANE_BINOP(|)
LANE_BINOP(==) LANE_BINOP(!=) LANE_BINOP(<) LANE_BINOP(<=) LANE_BINOP(>=)
#undef LANE_BINOP

#define LANE_FLOP(NAME, OP)                                         \
  template <class A, class B, class = if_lane<A, B>>                \
  Lane32<float> NAME(const A& a, const B& b) {                      \
    Lane32<float> r;                                                \
    for (int i = 0; i < 32; ++i)                                    \
      r.v[i] = (float)at(a, i) OP (float)at(b, i);                  \
    return r;                                                       \
  }
LANE_FLOP(hmm_mul, *) LANE_FLOP(hmm_add, +) LANE_FLOP(hmm_sub, -)
LANE_FLOP(hmm_div, /)
#undef LANE_FLOP

template <class C, class A, class B,
          class = std::enable_if_t<is_lane<C>::value || is_lane<A>::value ||
                                   is_lane<B>::value>>
Lane32<float> hmm_sel(const C& c, const A& a, const B& b) {
  Lane32<float> r;
  for (int i = 0; i < 32; ++i) r.v[i] = at(c, i) ? at(a, i) : at(b, i);
  return r;
}

// the chain filter's float32 compares (chain_flt.cuh) lane by lane
template <class A, class B, class = if_lane<A, B>>
Lane32<bool> flt_ge_mul(const A& d, const B& x, float m) {
  Lane32<bool> r;
  for (int i = 0; i < 32; ++i)
    r.v[i] = (float)at(d, i) >= (float)at(x, i) * m;
  return r;
}
template <class A, class B, class = if_lane<A, B>>
Lane32<bool> flt_lt_mul(const A& a, const B& x, float m) {
  Lane32<bool> r;
  for (int i = 0; i < 32; ++i)
    r.v[i] = (float)at(a, i) < (float)at(x, i) * m;
  return r;
}

// kswv.cuh's DPX max-adds and byte-permute score lane by lane
template <class A, class B, class C,
          class = std::enable_if_t<is_lane<A>::value || is_lane<B>::value ||
                                   is_lane<C>::value>>
Lane32<int> kswv_addmax(const A& a, const B& b, const C& c) {
  Lane32<int> r;
  for (int i = 0; i < 32; ++i) {
    const int x = at(a, i) + at(b, i), y = at(c, i);
    r.v[i] = x > y ? x : y;
  }
  return r;
}
template <class A, class B, class C,
          class = std::enable_if_t<is_lane<A>::value || is_lane<B>::value ||
                                   is_lane<C>::value>>
Lane32<int> kswv_addmax0(const A& a, const B& b, const C& c) {
  Lane32<int> r = kswv_addmax(a, b, c);
  for (int i = 0; i < 32; ++i) r.v[i] = r.v[i] > 0 ? r.v[i] : 0;
  return r;
}
template <class A, class B, class C,
          class = std::enable_if_t<is_lane<A>::value || is_lane<B>::value ||
                                   is_lane<C>::value>>
Lane32<int> kswv_max3(const A& a, const B& b, const C& c) {
  Lane32<int> r;
  for (int i = 0; i < 32; ++i) {
    const int x = at(a, i) > at(b, i) ? at(a, i) : at(b, i);
    r.v[i] = x > at(c, i) ? x : at(c, i);
  }
  return r;
}
template <class A, class B, class = if_lane<A, B>>
Lane32<int> kswv_score(const A& prof, const B& sel) {
  Lane32<int> r;
  for (int i = 0; i < 32; ++i) {
    const int c = at(sel, i) & 7;
    r.v[i] = c < 4 ? (int)(signed char)(unsigned char)(
                         (unsigned)at(prof, i) >> (8 * c))
                   : -1;
  }
  return r;
}

struct HostWarp {
  using F = Lane32<float>;
  using I = Lane32<int>;
  I lane() const {
    I r;
    for (int i = 0; i < 32; ++i) r.v[i] = i;
    return r;
  }
  // v of lane (lane - k) & 31
  F rot(const F& v, int k) const {
    F r;
    for (int i = 0; i < 32; ++i) r.v[i] = v.v[(i - k) & 31];
    return r;
  }
  template <class T>
  T bcast(const Lane32<T>& v, int src) const { return v.v[src]; }
  template <class T, class C>
  Lane32<T> load(const T* p, const I& idx, const C& ok, T other) const {
    Lane32<T> r;
    for (int i = 0; i < 32; ++i)
      r.v[i] = at(ok, i) ? p[idx.v[i]] : other;
    return r;
  }
  void store(float* p, const I& idx, const F& v) const {
    for (int i = 0; i < 32; ++i) p[idx.v[i]] = v.v[i];
  }
  void sync() const {}
  // the chain loop's register path: int lanes; the lockstep executor
  // is the one writer of what every lane computed alike
  bool lead() const { return true; }
  template <class C>
  I load_u8(const unsigned char* p, const I& idx, const C& ok) const {
    I r;
    for (int i = 0; i < 32; ++i) r.v[i] = at(ok, i) ? p[idx.v[i]] : 0;
    return r;
  }
  template <class C>
  void store_if(int* p, const I& idx, const I& v, const C& ok) const {
    for (int i = 0; i < 32; ++i)
      if (at(ok, i)) p[idx.v[i]] = v.v[i];
  }
  template <class C, class A, class B>
  I sel(const C& c, const A& a, const B& b) const {
    I r;
    for (int i = 0; i < 32; ++i) r.v[i] = at(c, i) ? at(a, i) : at(b, i);
    return r;
  }
  int shfl(const I& v, int src) const { return v.v[src]; }
  bool any(bool v) const { return v; }
  // v of lane - d (a lane below d keeps its own v)
  I shfl_up(const I& v, int d) const {
    I r;
    for (int i = 0; i < 32; ++i) r.v[i] = v.v[i >= d ? i - d : i];
    return r;
  }
  int max(const I& v) const {
    int m = v.v[0];
    for (int i = 1; i < 32; ++i) m = v.v[i] > m ? v.v[i] : m;
    return m;
  }
  template <class T>
  unsigned ballot(const Lane32<T>& c) const {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (c.v[i] ? 1u : 0u) << i;
    return m;
  }
};

#include "chain_flt.cuh"
#include "chain_loop.cuh"
#include "fm.cuh"
#include "k2_lcp.cuh"
#include "kswv.cuh"
#include "pairhmm.cuh"
#include "seed_strategy.cuh"
#include "smem_lcp.cuh"
#include "sw_extend.cuh"
#include "sweep_bwd.cuh"
#include "sweep_fwd.cuh"
#include "vpu_ceiling.cuh"

// One lane that is the whole warp: every shuffle and reduction returns
// the lane's own value.
struct SerialLanes {
  int lane() const { return 0; }
  int width() const { return 1; }
  int max(int v) const { return v; }
  int min(int v) const { return v; }
  int shfl_up(int v, int) const { return v; }
  int shfl(int v, int) const { return v; }
  bool any(bool v) const { return v; }
  void sync() const {}
};

// The SW logic with one lane holding all QP + 2 band columns (padded to
// SW_HOST_COLS); returns 1 for a wider query.
extern "C" int fgdp_sw_extend_host(const int* query, const int* target,
                                   const int* qlen, const int* tlen,
                                   const int* h0, int J, int QP, int TP,
                                   int w, int o_del, int e_del, int o_ins,
                                   int e_ins, int zdrop, int end_bonus,
                                   int mat_max, int mat_mis, int mat_amb,
                                   int* out, long long* cells) {
  if (QP + 2 > SW_HOST_COLS) return 1;
  SWParamsC p{o_del, e_del, o_ins, e_ins, zdrop, end_bonus, mat_max,
              mat_mis, mat_amb};
  SerialLanes L;
  for (int j = 0; j < J; ++j) {
    int res[SW_OUTS];
    long long c = sw_extend_job<SW_HOST_COLS>(
        query + (long long)j * QP, target + (long long)j * TP, QP, TP,
        qlen[j], tlen[j], h0[j], w, p, L, res);
    for (int k = 0; k < 6; ++k) out[(long long)k * J + j] = res[k];
    if (cells) cells[j] = c;
  }
  return 0;
}

extern "C" int fgdp_kswv_reg_max_qp() { return 32 * KSWV_MAX_K; }

template <int K>
static void kswv_regs_host(const int* q, const int* t, const int* qlen,
                           const int* tlen, int J, int QP, int TP,
                           const KswvParams& p, int* best, int* te,
                           int* best_row, int* row_max) {
  HostWarp L;
  std::vector<int> ring((size_t)KSWV_RING * K * 32);
  for (int j = 0; j < J; ++j)
    kswv_job_regs<K>(q + (long long)j * QP, t + (long long)j * TP, QP, TP,
                     qlen[j], tlen[j], p, L, ring.data(),
                     best_row + (long long)j * QP,
                     row_max + (long long)j * TP, best[j], te[j]);
}

// The kswv register path with 32 lockstep lanes, K = ceil(QP / 32) as on
// the card, the ring a host array; returns 1 where the C entry point
// takes the wide path (QP above fgdp_kswv_reg_max_qp(), or a or -b
// outside a signed byte).
extern "C" int fgdp_kswv_host(const int* q, const int* t, const int* qlen,
                              const int* tlen, int J, int QP, int TP, int a,
                              int b, int o_del, int e_del, int o_ins,
                              int e_ins, int* best, int* te, int* best_row,
                              int* row_max) {
  static_assert(KSWV_MAX_K == 8, "instantiate every K up to KSWV_MAX_K");
  const KswvParams p{a, b, o_del, e_del, o_ins, e_ins};
  if (!kswv_bytes_ok(p)) return 1;
#define KSWV_HOST(k)                                                   \
  case k:                                                              \
    kswv_regs_host<k>(q, t, qlen, tlen, J, QP, TP, p, best, te, best_row, \
                      row_max);                                        \
    return 0;
  switch (QP > 0 ? (QP + 31) / 32 : 1) {
    KSWV_HOST(1) KSWV_HOST(2) KSWV_HOST(3) KSWV_HOST(4)
    KSWV_HOST(5) KSWV_HOST(6) KSWV_HOST(7) KSWV_HOST(8)
  }
#undef KSWV_HOST
  return 1;
}

// The kswv wide path with one serial lane, any QP.
extern "C" int fgdp_kswv_wide_host(const int* q, const int* t,
                                   const int* qlen, const int* tlen, int J,
                                   int QP, int TP, int a, int b, int o_del,
                                   int e_del, int o_ins, int e_ins, int* best,
                                   int* te, int* best_row, int* row_max) {
  const KswvParams p{a, b, o_del, e_del, o_ins, e_ins};
  std::vector<int> scratch(2 * (size_t)QP + 1);
  SerialLanes L;
  for (int j = 0; j < J; ++j)
    kswv_job_wide(q + (long long)j * QP, t + (long long)j * TP, QP, TP,
                  qlen[j], tlen[j], p, L, scratch.data(),
                  scratch.data() + QP, best_row + (long long)j * QP,
                  row_max + (long long)j * TP, best[j], te[j]);
  return 0;
}

extern "C" int fgdp_chain_reg_max_c() { return 32 * CH_MAX_K; }

template <int K>
static void chain_regs_host(const ChainArgs& a) {
  std::vector<int> tb((size_t)CH_NFIELDS * a.C);
  HostWarp L;
  for (int b = 0; b < a.B; ++b) chain_read_regs<K>(a, b, tb.data(), L);
}

// The register path with 32 lockstep lanes, K = ceil(C / 32) as on the
// card; returns 1 for C outside [1, fgdp_chain_reg_max_c()].
extern "C" int fgdp_chain_loop_host(const int* qbeg, const int* rbeg,
                                    const int* slen, const int* rid,
                                    const unsigned char* valid,
                                    const unsigned char* ovf_in, int B,
                                    int P, int C, int l_pac, int w,
                                    int max_chain_gap, int* out, int* n_out,
                                    unsigned char* ovf_out, int* chain_of) {
  static_assert(CH_MAX_K == 8, "instantiate every K up to CH_MAX_K");
  ChainArgs a{qbeg, rbeg, slen, rid, valid, ovf_in, B, P, C, l_pac, w,
              max_chain_gap, out, n_out, ovf_out, chain_of};
  if (C < 1) return 1;
  switch ((C + 31) / 32) {
    case 1: chain_regs_host<1>(a); return 0;
    case 2: chain_regs_host<2>(a); return 0;
    case 3: chain_regs_host<3>(a); return 0;
    case 4: chain_regs_host<4>(a); return 0;
    case 5: chain_regs_host<5>(a); return 0;
    case 6: chain_regs_host<6>(a); return 0;
    case 7: chain_regs_host<7>(a); return 0;
    case 8: chain_regs_host<8>(a); return 0;
  }
  return 1;
}

// The wide path with one serial lane over the shared-memory layout.
extern "C" int fgdp_chain_loop_wide_host(const int* qbeg, const int* rbeg,
                                         const int* slen, const int* rid,
                                         const unsigned char* valid,
                                         const unsigned char* ovf_in, int B,
                                         int P, int C, int l_pac, int w,
                                         int max_chain_gap, int* out,
                                         int* n_out, unsigned char* ovf_out,
                                         int* chain_of) {
  ChainArgs a{qbeg, rbeg, slen, rid, valid, ovf_in, B, P, C, l_pac, w,
              max_chain_gap, out, n_out, ovf_out, chain_of};
  std::vector<int> st((size_t)CH_NFIELDS * C);
  SerialLanes L;
  for (int b = 0; b < B; ++b) chain_read_wide(a, b, st.data(), L);
  return 0;
}

// The chain filter with 32 lockstep lanes (fgdp_chain_flt's arguments
// but the events and stream); returns 1 for C < 1.
extern "C" int fgdp_chain_flt_host(const int* n, const int* pos,
                                   const int* crid, const int* fq,
                                   const int* lq, const int* ll,
                                   const int* weight,
                                   const unsigned char* is_alt,
                                   int n_contigs, int B, int C,
                                   int min_chain_weight, int min_seed_len,
                                   int max_chain_gap, int max_chain_extend,
                                   float mask_level, float drop_ratio,
                                   int* kept) {
  if (C < 1) return 1;
  const FltArgs a{n, pos, crid, fq, lq, ll, weight, is_alt, n_contigs, B,
                  C, min_chain_weight, min_seed_len, max_chain_gap,
                  max_chain_extend, mask_level, drop_ratio, kept};
  std::vector<int> sm((size_t)FLT_NARR * C);
  HostWarp L;
  for (int b = 0; b < B; ++b) chain_flt_read(a, b, sm.data(), L);
  return 0;
}

template <int K>
static void pairhmm_regs_host(const int* reads, const float* pq,
                              const float* trans, const int* haps,
                              const int* rlens, const int* hlens, int NP,
                              int R, int H, int n_doubling, float* acc) {
  std::vector<float> buf(32 * K);
  HostWarp L;
  for (int p = 0; p < NP; ++p)
    acc[p] = pairhmm_pair_regs<K>(
        reads + (long long)p * R, pq + (long long)p * R,
        trans + (long long)p * R * 6, haps + (long long)p * H, rlens[p],
        hlens[p], n_doubling, buf.data(), L);
}

extern "C" int fgdp_pairhmm_reg_max_h() { return 32 * HMM_MAX_K - 1; }

// The register path with 32 lockstep lanes, K = ceil((H + 1) / 32) as
// on the card; returns 1 for H above fgdp_pairhmm_reg_max_h().
extern "C" int fgdp_pairhmm_f32_host(const int* reads, const float* pq,
                                     const float* trans, const int* haps,
                                     const int* rlens, const int* hlens,
                                     int NP, int R, int H, int n_doubling,
                                     float* acc) {
  static_assert(HMM_MAX_K == 20, "instantiate every K up to HMM_MAX_K");
#define HMM_HOST(k)                                                       \
  case k:                                                                 \
    pairhmm_regs_host<k>(reads, pq, trans, haps, rlens, hlens, NP, R, H, \
                         n_doubling, acc);                                \
    return 0;
  switch ((H + 1 + 31) / 32) {
    HMM_HOST(1) HMM_HOST(2) HMM_HOST(3) HMM_HOST(4) HMM_HOST(5)
    HMM_HOST(6) HMM_HOST(7) HMM_HOST(8) HMM_HOST(9) HMM_HOST(10)
    HMM_HOST(11) HMM_HOST(12) HMM_HOST(13) HMM_HOST(14) HMM_HOST(15)
    HMM_HOST(16) HMM_HOST(17) HMM_HOST(18) HMM_HOST(19) HMM_HOST(20)
  }
#undef HMM_HOST
  return 1;
}

// The wide path with one serial lane over the shared-memory layout.
extern "C" int fgdp_pairhmm_f32_wide_host(const int* reads, const float* pq,
                                          const float* trans,
                                          const int* haps, const int* rlens,
                                          const int* hlens, int NP, int R,
                                          int H, int n_doubling,
                                          float* acc) {
  const int stride = H + 1;
  std::vector<float> st((size_t)6 * stride);
  float* s = st.data();
  HmmBufs b{{s, s + stride}, {s + 2 * stride, s + 3 * stride},
            {s + 4 * stride, s + 5 * stride}};
  SerialLanes L;
  for (int p = 0; p < NP; ++p)
    acc[p] = pairhmm_pair_wide(reads + (long long)p * R,
                               pq + (long long)p * R,
                               trans + (long long)p * R * 6,
                               haps + (long long)p * H, rlens[p], hlens[p],
                               n_doubling, b, L);
  return 0;
}

template <int NCH>
static void vpu_host(const void* x, void* out, long long n, int steps,
                     int is_int, const VpuConsts& k) {
  for (long long i = 0; i < n; ++i) {
    if (is_int)
      ((int*)out)[i] = vpu_int32_element<NCH>(((const int*)x)[i], steps, k);
    else
      ((float*)out)[i] =
          vpu_fp32_element<NCH>(((const float*)x)[i], steps, k);
  }
}

extern "C" int fgdp_vpu_ceiling_host(const void* x, void* out, long long n,
                                     int steps, int n_chains, int is_int,
                                     const float* scale, const float* mul,
                                     const float* add, const int* seed,
                                     const int* a, const int* b) {
  VpuConsts k;
  for (int i = 0; i < VPU_MAX_CHAINS; ++i) {
    k.scale[i] = scale[i];
    k.mul[i] = mul[i];
    k.add[i] = add[i];
    k.seed[i] = seed[i];
    k.a[i] = a[i];
    k.b[i] = b[i];
  }
  switch (n_chains) {
    case 4: vpu_host<4>(x, out, n, steps, is_int, k); return 0;
    case 8: vpu_host<8>(x, out, n, steps, is_int, k); return 0;
    case 16: vpu_host<16>(x, out, n, steps, is_int, k); return 0;
  }
  return 1;
}

// The seeding wave machines' grid with every lane in one thread: the
// counts are the thread's own, and no thread comes before it.
struct SerialGrid {
  ModeCounts counts(const ModeCounts& loc, int) const { return loc; }
  int exscan(int, int) const { return 0; }
};

static FmView fm_view(const int* occ, long long nblocks, const int* counts,
                      const int* c2, const int* sa, long long sa_len,
                      int sentinel_row, int r1_row, int cc_r0, int cc_r1) {
  return FmView{occ,    nblocks,      counts, c2,    sa,
                sa_len, sentinel_row, r1_row, cc_r0, cc_r1};
}

#define FM_HOST_ARGS                                                       \
  const int *occ, long long nblocks, const int *counts, const int *c2,     \
      const int *sa, long long sa_len, int sentinel_row, int r1_row,       \
      int cc_r0, int cc_r1
#define FM_VIEW                                                        \
  fm_view(occ, nblocks, counts, c2, sa, sa_len, sentinel_row, r1_row, \
          cc_r0, cc_r1)

// The rank primitives on n intervals: out int32[n, FM_HOST_COLS] holds
// occ4(k) (4), backward_extend2(k, s, ca, cb) (k1, s1, k2, s2),
// forward_extend2(k, l, s, ca, cb) (k1, l1, s1, k2, l2, s2),
// init_interval(ca) (k, l, s) and sa_lookup(k).
#define FM_HOST_COLS 18
extern "C" int fgdp_fm_host(FM_HOST_ARGS, int n, const int* k, const int* l,
                            const int* s, const int* ca, const int* cb,
                            int* out) {
  const FmView fm = FM_VIEW;
  for (int i = 0; i < n; ++i) {
    int* o = out + (long long)i * FM_HOST_COLS;
    fm_occ4(fm, k[i], o);
    fm_backward_extend2(fm, k[i], s[i], ca[i], cb[i], o[4], o[5], o[6],
                        o[7]);
    fm_forward_extend2(fm, k[i], l[i], s[i], ca[i], cb[i], o[8], o[9],
                       o[10], o[11], o[12], o[13]);
    fm_init_interval(fm, ca[i], o[14], o[15], o[16]);
    o[17] = fm_sa_lookup(fm, k[i]);
  }
  return 0;
}

// K1's step with each WALK step logged (8 ints: read, len, l before,
// the position compared from, then l, r, mode and pos after), for the
// tests' coverage of the packed compare's edges
template <class Rows>
struct LoggedStep {
  LcpStep<Rows> inner;
  std::vector<int>* log;
  void operator()(LcpLane& st, int mode) const {
    if (mode != SEED_WALK) return inner(st, mode);
    const int pos = st.pos < 0 ? fm_sa_lookup(inner.A.fm, st.lo) : st.pos;
    const int id = st.id, len = st.len, l = st.l;
    inner(st, mode);
    log->insert(log->end(), {id, len, l, pos, st.l, st.r, st.mode, st.pos});
  }
};

// K1 (fgdp_smem_lcp's arguments but the block size, the launch's
// scratch and stream; `staged`: 1 reads the codes from every read's
// staged words, lcp_stage_word's, 0 where they lie; walk_log int32[cap,
// 8] receives LoggedStep's rows, or null). Returns the WALK steps taken.
extern "C" int fgdp_smem_lcp_host(
    FM_HOST_ARGS, const int* tree, const int* isa, const int* codes,
    const int* lens, const unsigned char* active, const long long* words,
    long long nwords, int B, int L, int N, int l2ref, int msl, int S,
    int max_rounds, int* out_m, int* out_n, int* out_k, int* out_s,
    int* count, unsigned char* overflow, int staged, int* walk_log,
    int cap) {
  const LcpArgs A{FM_VIEW, tree, isa, codes, lens, active, words, nwords,
                  B, L, N, l2ref, msl,
                  SeedRows{out_m, out_n, out_k, out_s, S}, count, overflow,
                  nullptr};
  std::vector<LcpLane> ln(B);
  for (int i = 0; i < B; ++i) lcp_lane_init(A, ln[i], i);
  int kc[20];
  for (int t = 0; t < 4; ++t) kc[t] = counts[t];
  for (int t = 0; t < 16; ++t) kc[4 + t] = c2[t];
  SerialGrid g;
  std::vector<int> log;
  const int nw = (L + 31) / 32;
  std::vector<LcpWord> rows((size_t)B * nw + 1);
  for (int i = 0; staged && i < B; ++i)
    for (int w = 0; w < nw; ++w)
      rows[(size_t)i * nw + w] = lcp_stage_word(A, i, w);
  const LcpStaged st_rows{rows.data(), nw, 0, kc};
  const LcpInPlace ip_rows{kc};
  if (staged)
    lcp_machine(A, g, ln, max_rounds,
                LoggedStep<LcpStaged>{{A, st_rows}, &log});
  else
    lcp_machine(A, g, ln, max_rounds,
                LoggedStep<LcpInPlace>{{A, ip_rows}, &log});
  for (int i = 0; i < B; ++i) lcp_lane_finish(A, ln[i]);
  const int steps = (int)(log.size() / 8);
  for (int i = 0; walk_log != nullptr && i < 8 * std::min(steps, cap); ++i)
    walk_log[i] = log[i];
  return steps;
}

// One WALK step of n lanes, lane i on read row i of codes int32[n, L]
// (its len, l, r, lo, hi, pos from the arrays), staged or in place;
// state int32[n, 8] receives l, r, lo, hi, pos, mode, cnt and the bytes
// gathered, the seed rows int32[n, S] and count int32[n] its seed.
extern "C" int fgdp_lcp_walk_host(
    FM_HOST_ARGS, const int* isa, const int* codes, const int* lens,
    const long long* words, long long nwords, int n, int L, int N,
    int l2ref, int msl, int S, const int* l, const int* r, const int* lo,
    const int* hi, const int* pos, int* state, int* out_m, int* out_n,
    int* out_k, int* out_s, int* count, int staged) {
  std::vector<unsigned char> active(n, 1), ovf(n, 0);
  const LcpArgs A{FM_VIEW, nullptr, isa, codes, lens, active.data(), words,
                  nwords, n, L, N, l2ref, msl,
                  SeedRows{out_m, out_n, out_k, out_s, S}, count,
                  ovf.data(), nullptr};
  int kc[20] = {0};
  const int nw = (L + 31) / 32;
  std::vector<LcpWord> rows((size_t)n * nw + 1);
  for (int i = 0; i < n; ++i)
    for (int w = 0; w < nw; ++w)
      rows[(size_t)i * nw + w] = lcp_stage_word(A, i, w);
  const LcpStaged st_rows{rows.data(), nw, 0, kc};
  const LcpInPlace ip_rows{kc};
  for (int i = 0; i < n; ++i) {
    LcpLane st;
    lcp_lane_init(A, st, i);
    st.l = l[i];
    st.r = r[i];
    st.lo = lo[i];
    st.hi = hi[i];
    st.pos = pos[i];
    st.mode = SEED_WALK;
    if (staged)
      lcp_walk(A, st_rows, st);
    else
      lcp_walk(A, ip_rows, st);
    int* o = state + 8LL * i;
    o[0] = st.l;
    o[1] = st.r;
    o[2] = st.lo;
    o[3] = st.hi;
    o[4] = st.pos;
    o[5] = st.mode;
    o[6] = st.cnt;
    o[7] = st.gb;
    count[i] = st.cnt;
  }
  return 0;
}

// K2 (fgdp_k2_lcp's arguments but the launch's scratch and stream)
extern "C" int fgdp_k2_lcp_host(
    FM_HOST_ARGS, const int* tree, const int* isa, const int* codes,
    const int* lens, const int* k_read, const int* job_x, const int* job_mi,
    const int* job_pos, const int* job_d0, const unsigned char* k_on, int NK,
    int L, int N, int l2ref, int msl, int sj_cap, int ascent_cap,
    int max_rounds, int* out_m, int* out_n, int* out_k, int* out_s,
    int* count, unsigned char* overflow) {
  const K2Args A{FM_VIEW, tree, isa, codes, lens, k_read, job_x, job_mi,
                 job_pos, job_d0, k_on, NK, L, N, l2ref, msl, ascent_cap,
                 SeedRows{out_m, out_n, out_k, out_s, sj_cap}, count,
                 overflow, nullptr};
  std::vector<K2Lane> ln(NK);
  for (int i = 0; i < NK; ++i) k2_lane_init(A, ln[i], i);
  SerialGrid g;
  k2_machine(A, g, ln, max_rounds);
  for (int i = 0; i < NK; ++i) k2_lane_finish(A, ln[i]);
  return 0;
}

// K3's group of FM_GROUP lanes in lockstep: a lane value is an array of
// 16, each() runs a functor once a lane, get() reads one lane; the one
// thread is the lead lane and stages the codes.
struct HostGroup16 {
  using I = std::array<int, FM_GROUP>;
  template <class F>
  I each(const F& f) const {
    I r;
    for (int g = 0; g < FM_GROUP; ++g) r[g] = f(g);
    return r;
  }
  int get(const I& v, int src) const { return v[src]; }
  bool lead() const { return true; }
  void stage(signed char* buf, const int* row, int L) const {
    for (int u = 0; u < L; ++u) buf[u] = k3_code8(row[u]);
  }
  // D9's anchor exits, counted where asked for
  long long* exits = nullptr;
  void note(int e) const {
    if (exits != nullptr) ++exits[e];
  }
  // D9's staged row from word w0 on; the words before it all N of code
  // 1 (read as 4), so that a lane reading one would differ
  void stage(LcpWord* buf, const int* row, int L, int w0) const {
    for (int w = 0; w < sweep_row_words(L); ++w)
      buf[w] = w < w0 ? LcpWord{LCP_EVEN, LCP_EVEN}
                      : lcp_stage_row_word(row, L, w);
  }
};

// The group ranks and forward_extend2 on n intervals: out int32[n,
// FM_GROUP_COLS] holds the 16 lanes' ranks (fm_group_rank), fm_fetch's
// ranks of the same rows (occ1 and occ2c at l, then at l + s), the
// group's forward_extend2 (k1, l1, s1, k2, l2, s2) and fm_forward_extend2's.
#define FM_GROUP_COLS 44
extern "C" int fgdp_fm_group_host(FM_HOST_ARGS, int n, const int* k,
                                  const int* l, const int* s, const int* ca,
                                  const int* cb, int* out) {
  const FmView fm = FM_VIEW;
  const HostGroup16 grp;
  for (int i = 0; i < n; ++i) {
    int* o = out + (long long)i * FM_GROUP_COLS;
    const int cf = 3 - fm_clamp3(ca[i]);
    const auto v = grp.each(FmGroupRank{fm, l[i], s[i], cf});
    for (int g = 0; g < FM_GROUP; ++g) o[g] = v[g];
    FmRanks lo, hi;
    fm_fetch(fm, l[i], cf, lo);
    fm_fetch(fm, l[i] + s[i], cf, hi);
    for (int t = 0; t < 4; ++t) {
      o[16 + t] = lo.occ1[t];
      o[20 + t] = lo.occ2c[t];
      o[24 + t] = hi.occ1[t];
      o[28 + t] = hi.occ2c[t];
    }
    fm_forward_extend2_group(fm, grp, k[i], l[i], s[i], ca[i], cb[i], o[32],
                             o[33], o[34], o[35], o[36], o[37]);
    fm_forward_extend2(fm, k[i], l[i], s[i], ca[i], cb[i], o[38], o[39],
                       o[40], o[41], o[42], o[43]);
  }
  return 0;
}

// K3 (fgdp_seed_strategy's arguments but the events and stream, and
// `staged`: 1 reads the codes from the group's buffer, 0 where they lie)
extern "C" int fgdp_seed_strategy_host(
    FM_HOST_ARGS, const int* codes, const int* lens,
    const unsigned char* active, int B, int L, int max_intv, int msl, int S,
    int* out_m, int* out_n, int* out_k, int* out_s, int* count,
    unsigned char* overflow, long long* work, int staged) {
  const K3Args A{FM_VIEW, codes, lens, active, B, L, max_intv, msl,
                 SeedRows{out_m, out_n, out_k, out_s, S}, count, overflow,
                 work};
  const HostGroup16 grp;
  std::vector<signed char> buf((size_t)L + 1);
  for (int rd = 0; rd < B; ++rd)
    k3_read(A, rd, grp, staged ? buf.data() : nullptr);
  return 0;
}

// D9 (fgdp_sweep_fwd's arguments but the events and stream, and
// `staged`: 1 reads the codes from the group's staged row, 0 where they
// lie, -1 as the card chooses by L; `exits` int64[SWEEP_EXITS] or null
// counts how the anchors end), each lane's group of 16 lanes in
// lockstep, one lane after another
template <bool STAGED>
static void sweep_fwd_host_lane(const SweepFwdArgs& A, int t, int restart,
                                int walk, LcpWord* buf, long long* exits) {
  const HostGroup16 grp{exits};
  if (restart && walk)
    sweep_fwd_lane<true, true, STAGED>(A, t, grp, buf);
  else if (restart)
    sweep_fwd_lane<true, false, STAGED>(A, t, grp, buf);
  else if (walk)
    sweep_fwd_lane<false, true, STAGED>(A, t, grp, buf);
  else
    sweep_fwd_lane<false, false, STAGED>(A, t, grp, buf);
}

extern "C" int fgdp_sweep_fwd_host(
    FM_HOST_ARGS, const int* codes, const int* lens, const int* rid,
    const int* x0, const int* min_intv, const unsigned char* active,
    const long long* words, long long nwords, int B, int L, int NL, int E,
    int prev_cap, int l2ref, int restart, int walk, int* em, int* en,
    int* ek, int* es, int* ecount, unsigned char* povf, unsigned char* eovf,
    long long* work, int staged, long long* exits) {
  const SweepFwdArgs A{FM_VIEW, codes, lens,     rid,   x0,     min_intv,
                       active,  words, nwords,   B,     L,      NL,
                       E,       prev_cap, l2ref, em,    en,     ek,
                       es,      ecount, povf,    eovf,  work};
  std::vector<LcpWord> buf((size_t)sweep_row_words(L) + 1);
  const bool st = staged < 0 ? sweep_staged(L) : staged != 0;
  for (int t = 0; t < NL; ++t) {
    if (st)
      sweep_fwd_host_lane<true>(A, t, restart, walk, buf.data(), exits);
    else
      sweep_fwd_host_lane<false>(A, t, restart, walk, buf.data(), exits);
  }
  return 0;
}

// 1 where the card stages D9's codes at row length L, else 0
extern "C" int fgdp_sweep_fwd_staged_host(int L) { return sweep_staged(L); }

// D10 (fgdp_sweep_bwd's arguments but the events and stream), one lane
// after another
extern "C" int fgdp_sweep_bwd_host(
    FM_HOST_ARGS, const int* codes, const int* lens, const int* rid,
    const int* anc, const int* k, const int* s, const int* mi,
    const unsigned char* on, const long long* words, long long nwords, int B,
    int L, int NL, int l2ref, int* out_m, int* out_kf, int* out_sf,
    long long* work) {
  const SweepBwdArgs A{FM_VIEW, codes, lens,  rid, anc,   k,     s,
                       mi,      on,    words, nwords, B,  L,     NL,
                       l2ref,   out_m, out_kf, out_sf, work};
  for (int t = 0; t < NL; ++t) sweep_bwd_lane(A, t);
  return 0;
}
