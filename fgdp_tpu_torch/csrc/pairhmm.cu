// PairHMM forward kernel for Hopper (sm_90a), float32 pass.
//
// Replaces the TPU kernel fgdp_tpu/ops/pairhmm_pallas.py (_kernel,
// launched by forward_f32_pallas): the GKL forward DP of every
// (read, haplotype) pair, scaled by 2^120, giving the raw sum over the
// last row's M + X. The caller takes log10 and sends the pairs whose
// unscaled result is below MIN_ACCEPTED to the float64 pass.
//
// Design: one warp per pair, the pair's whole DP row in registers
// (pairhmm.cuh, pairhmm_pair_regs). Lane l holds columns 32 r + l of M,
// X and Y, r < K = ceil((H + 1) / 32), K a template parameter (every K up
// to HMM_MAX_K is instantiated: H <= 639). A row is a fixed sequence of
// register operations: the shifts by one column (M; X + Y; Mi for u) and
// the log-doubling scan's shifts by k = 1..16 are warp rotations, one
// __shfl_sync and one select a register; k = 32, 64, ... are register
// moves. The rows' inputs are loaded 32 rows ahead, one row a lane, and
// broadcast by shuffle; the haplotype codes are loaded once. A warp runs
// its own pair's rlen rows (a warp-uniform bound) and sums its last row
// in column order through shared memory. Launches whose H is above
// 32 HMM_MAX_K - 1 take the wide path, the same DP with the row in shared
// memory (pairhmm_pair_wide); the C entry point chooses from H before
// the launch and reports the path.
//
// What does not apply here: an anti-diagonal wavefront (gpuPairHMM)
// cannot give the same bits, because a row's log-doubling scan needs that
// row's whole u first; tensor-core products (wgmma, mma.sync) would
// round otherwise; a pair's inputs are a few KB, so TMA and cp.async buy
// nothing.
//
// What bounds it: on full launches, issuing the row loop's
// instructions: 734 SASS instructions a warp row at K = 13, 56 a
// register (python -m fgdp_tpu_torch.probes.sass; the count holds the
// doublings only an uncapped launch runs and the next chunk's loads),
// against the 27 float32 operations a cell the bound counts. On the
// small launches mutect makes (a few hundred pairs, two or three warps
// an SM), the latency of a row's chain of dependent shuffles and
// arithmetic. The bytes are the inputs read once and one float out per
// pair. Registers: 48 at K = 1 to 167 at K = 20; K = 6 and K = 10 keep
// one value in 4 bytes of local memory, stored before the row loop and
// read once after it.
#include <cuda_runtime.h>

#include "pairhmm.cuh"

#define HMM_WARPS 4   // pairs (warps) per block

template <int K>
__global__ void __launch_bounds__(HMM_WARPS * 32)
    pairhmm_regs_kernel(const int* __restrict__ reads,
                        const float* __restrict__ pq,
                        const float* __restrict__ trans,
                        const int* __restrict__ haps,
                        const int* __restrict__ rlens,
                        const int* __restrict__ hlens, int NP, int R, int H,
                        int n_doubling, float* __restrict__ acc) {
  __shared__ float sums[HMM_WARPS][32 * K];
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * HMM_WARPS + w;
  if (p >= NP) return;   // whole warps: every shuffle sees 32 lanes
  HmmWarp L;
  const float s = pairhmm_pair_regs<K>(
      reads + (long long)p * R, pq + (long long)p * R,
      trans + (long long)p * R * 6, haps + (long long)p * H, rlens[p],
      hlens[p], n_doubling, sums[w], L);
  if (L.lane() == 0) acc[p] = s;
}

__global__ void pairhmm_wide_kernel(const int* __restrict__ reads,
                                    const float* __restrict__ pq,
                                    const float* __restrict__ trans,
                                    const int* __restrict__ haps,
                                    const int* __restrict__ rlens,
                                    const int* __restrict__ hlens, int NP,
                                    int R, int H, int n_doubling,
                                    float* __restrict__ acc) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= NP) return;
  const int stride = H + 1;
  float* base = smem + (long long)warp * 6 * stride;
  HmmBufs b{{base, base + stride},
            {base + 2 * stride, base + 3 * stride},
            {base + 4 * stride, base + 5 * stride}};
  WarpLanes L;
  const float s = pairhmm_pair_wide(reads + (long long)p * R,
                                    pq + (long long)p * R,
                                    trans + (long long)p * R * 6,
                                    haps + (long long)p * H, rlens[p],
                                    hlens[p], n_doubling, b, L);
  if (L.lane() == 0) acc[p] = s;
}

#define HMM_ARGS \
  reads, pq, trans, haps, rlens, hlens, NP, R, H, n_doubling, acc

static void launch_regs(int K, const int* reads, const float* pq,
                        const float* trans, const int* haps,
                        const int* rlens, const int* hlens, int NP, int R,
                        int H, int n_doubling, float* acc, cudaStream_t s) {
  static_assert(HMM_MAX_K == 20, "instantiate every K up to HMM_MAX_K");
  const int blocks = (NP + HMM_WARPS - 1) / HMM_WARPS;
#define HMM_LAUNCH(k)                                                    \
  case k:                                                                \
    pairhmm_regs_kernel<k><<<blocks, HMM_WARPS * 32, 0, s>>>(HMM_ARGS); \
    break;
  switch (K) {
    HMM_LAUNCH(1) HMM_LAUNCH(2) HMM_LAUNCH(3) HMM_LAUNCH(4) HMM_LAUNCH(5)
    HMM_LAUNCH(6) HMM_LAUNCH(7) HMM_LAUNCH(8) HMM_LAUNCH(9) HMM_LAUNCH(10)
    HMM_LAUNCH(11) HMM_LAUNCH(12) HMM_LAUNCH(13) HMM_LAUNCH(14)
    HMM_LAUNCH(15) HMM_LAUNCH(16) HMM_LAUNCH(17) HMM_LAUNCH(18)
    HMM_LAUNCH(19) HMM_LAUNCH(20)
  }
#undef HMM_LAUNCH
}

// the widest H the register path takes
extern "C" int fgdp_pairhmm_reg_max_h() { return 32 * HMM_MAX_K - 1; }

// reads int32[NP, R], pq f32[NP, R], trans f32[NP, R, 6],
// haps int32[NP, H], rlens/hlens int32[NP] (rlen <= R, hlen <= H);
// acc f32[NP]. *path (host memory) receives the path taken: 0 the
// register path (H <= fgdp_pairhmm_reg_max_h()), 1 the wide one.
// ev_start/ev_end are cudaEvent_t or null, recorded on `stream` just
// before and just after the launch (no host time falls between them).
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue when one warp's wide state does not fit in
// shared memory (H above ~9,400).
extern "C" int fgdp_pairhmm_f32(const int* reads, const float* pq,
                                const float* trans, const int* haps,
                                const int* rlens, const int* hlens, int NP,
                                int R, int H, int n_doubling, float* acc,
                                int* path, void* ev_start, void* ev_end,
                                void* stream) {
  if (H < 0 || R < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int K = (H + 1 + 31) / 32;
  if (K <= HMM_MAX_K) {
    *path = 0;
    fgdp_record(ev_start, s);
    if (NP > 0)
      launch_regs(K, reads, pq, trans, haps, rlens, hlens, NP, R, H,
                  n_doubling, acc, s);
    fgdp_record(ev_end, s);
    return (int)cudaGetLastError();
  }
  const size_t per_warp = 6 * (size_t)(H + 1) * sizeof(float);
  const size_t cap = 220 * 1024;
  if (per_warp > cap) return (int)cudaErrorInvalidValue;
  int warps = 4;
  while (warps > 1 && warps * per_warp > cap) warps >>= 1;
  const size_t bytes = warps * per_warp;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pairhmm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  *path = 1;
  fgdp_record(ev_start, s);
  if (NP > 0)
    pairhmm_wide_kernel<<<(NP + warps - 1) / warps, warps * 32, bytes, s>>>(
        HMM_ARGS);
  fgdp_record(ev_end, s);
  return (int)cudaGetLastError();
}
