// Host twin of the CUDA kernels, for the CPU tests only: g++ builds the
// kernels' own per-job (sw_extend.cuh), per-read (chain_loop.cuh),
// per-pair (pairhmm.cuh) and per-element (vpu_ceiling.cuh) logic into a
// plain C library, run serially, so
// the logic can be held against the plain PyTorch versions where there is
// no nvcc. It builds with -ffp-contract=off, so that no multiply and add
// fuse into one rounding, as on the card. The port's CPU path never calls
// it; it runs the plain PyTorch versions.
#include <cstddef>
#include <vector>

#include "chain_loop.cuh"
#include "pairhmm.cuh"
#include "sw_extend.cuh"
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

extern "C" int fgdp_chain_loop_host(const int* qbeg, const int* rbeg,
                                    const int* slen, const int* rid,
                                    const unsigned char* valid,
                                    const unsigned char* ovf_in, int B,
                                    int P, int C, int l_pac, int w,
                                    int max_chain_gap, int* out, int* n_out,
                                    unsigned char* ovf_out, int* chain_of) {
  ChainArgs a{qbeg, rbeg, slen, rid, valid, ovf_in, B, P, C, l_pac, w,
              max_chain_gap, out, n_out, ovf_out, chain_of};
  std::vector<int> st((size_t)CH_NFIELDS * C);
  SerialLanes L;
  for (int b = 0; b < B; ++b) chain_read(a, b, st.data(), L);
  return 0;
}

extern "C" int fgdp_pairhmm_f32_host(const int* reads, const float* pq,
                                     const float* trans, const int* haps,
                                     const int* rlens, const int* hlens,
                                     int NP, int R, int H, int n_doubling,
                                     float* acc) {
  const int stride = H + 1;
  std::vector<float> st((size_t)6 * stride);
  float* s = st.data();
  HmmBufs b{{s, s + stride}, {s + 2 * stride, s + 3 * stride},
            {s + 4 * stride, s + 5 * stride}};
  SerialLanes L;
  for (int p = 0; p < NP; ++p)
    acc[p] = pairhmm_pair(reads + (long long)p * R, pq + (long long)p * R,
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
