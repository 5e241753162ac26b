// Batched local Smith-Waterman forward kernel (mate rescue) for Hopper
// (sm_90a).
//
// Replaces the JAX package's device loop fgdp_tpu/ops/kswv.py _forward
// (D6: a jitted lax.fori_loop over the target rows, not a Pallas
// kernel), which ksw_align_local_batch runs twice a rescue round: on the
// jobs, then on the hits' reversed prefixes. For every job it gives the
// best local score, the first target row that reaches it, that row's H
// and every row's max (kswv.cuh).
//
// Design: one warp per job, the job's DP row in registers (kswv.cuh,
// kswv_job_regs<K>): lane l holds K consecutive query columns, K =
// ceil(QP / 32) a template parameter (K = 5 at the mates' QP of 160;
// every K up to KSWV_MAX_K = 8, QP <= 256, is instantiated). A row's in-row
// gap term is an in-lane running max plus a 5-step __shfl_up_sync scan of
// the lane totals, the row max a __reduce_max_sync; the target codes are
// read 32 at a time and broadcast by shuffle, and the row maxima stored
// 32 rows at a time. A job's scalars are warp-uniform, so the warp runs
// its own min(tlen, TP) rows; an empty job (the padding of the job
// bucket) leaves at once. Launches whose QP is above 32 KSWV_MAX_K take
// the wide path (kswv_job_wide): the row's H and E in the job's scratch
// rows in global memory, 32 columns at a time. The C entry point chooses
// from QP before the launch and reports the path.
//
// What bounds it: issuing the row loop's instructions. A cell of
// _forward is 28 int32 operations (scores, M, E, F, H, the masks, the
// row max and the best row's select); the kernel issues its row loop
// once a warp row whatever the lanes' live columns (python -m
// fgdp_tpu_torch.probes.sass). The bytes are the inputs read once and
// the outputs written once: the best row and the row maxima dominate.
#include <cuda_runtime.h>

#include "kswv.cuh"

#define KSWV_WARPS 4   // jobs (warps) per block

template <int K>
__global__ void __launch_bounds__(KSWV_WARPS * 32)
    kswv_regs_kernel(const int* __restrict__ q, const int* __restrict__ t,
                     const int* __restrict__ qlen,
                     const int* __restrict__ tlen, int J, int QP, int TP,
                     KswvParams p, int* __restrict__ best,
                     int* __restrict__ te, int* __restrict__ best_row,
                     int* __restrict__ row_max) {
  const int j = blockIdx.x * KSWV_WARPS + (threadIdx.x >> 5);
  if (j >= J) return;   // whole warps: every shuffle sees 32 lanes
  WarpLanes L;
  int b, e;
  kswv_job_regs<K>(q + (long long)j * QP, t + (long long)j * TP, QP, TP,
                   qlen[j], tlen[j], p, L, best_row + (long long)j * QP,
                   row_max + (long long)j * TP, b, e);
  if (L.lane() == 0) {
    best[j] = b;
    te[j] = e;
  }
}

__global__ void __launch_bounds__(KSWV_WARPS * 32)
    kswv_wide_kernel(const int* __restrict__ q, const int* __restrict__ t,
                     const int* __restrict__ qlen,
                     const int* __restrict__ tlen, int J, int QP, int TP,
                     KswvParams p, int* __restrict__ best,
                     int* __restrict__ te, int* __restrict__ best_row,
                     int* __restrict__ row_max, int* __restrict__ scratch) {
  const int j = blockIdx.x * KSWV_WARPS + (threadIdx.x >> 5);
  if (j >= J) return;
  WarpLanes L;
  int b, e;
  int* hs = scratch + (long long)j * 2 * QP;
  kswv_job_wide(q + (long long)j * QP, t + (long long)j * TP, QP, TP,
                qlen[j], tlen[j], p, L, hs, hs + QP,
                best_row + (long long)j * QP, row_max + (long long)j * TP,
                b, e);
  if (L.lane() == 0) {
    best[j] = b;
    te[j] = e;
  }
}

#define KSWV_ARGS q, t, qlen, tlen, J, QP, TP, p, best, te, best_row, row_max

static void launch_regs(int K, const int* q, const int* t, const int* qlen,
                        const int* tlen, int J, int QP, int TP,
                        const KswvParams& p, int* best, int* te,
                        int* best_row, int* row_max, cudaStream_t s) {
  static_assert(KSWV_MAX_K == 8, "instantiate every K up to KSWV_MAX_K");
  const int blocks = (J + KSWV_WARPS - 1) / KSWV_WARPS;
#define KSWV_LAUNCH(k)                                                  \
  case k:                                                               \
    kswv_regs_kernel<k><<<blocks, KSWV_WARPS * 32, 0, s>>>(KSWV_ARGS); \
    break;
  switch (K) {
    KSWV_LAUNCH(1) KSWV_LAUNCH(2) KSWV_LAUNCH(3) KSWV_LAUNCH(4)
    KSWV_LAUNCH(5) KSWV_LAUNCH(6) KSWV_LAUNCH(7) KSWV_LAUNCH(8)
  }
#undef KSWV_LAUNCH
}

// the widest QP the register path takes
extern "C" int fgdp_kswv_reg_max_qp() { return 32 * KSWV_MAX_K; }

// q int32[J, QP], t int32[J, TP], qlen/tlen int32[J]; best/te int32[J],
// best_row int32[J, QP], row_max int32[J, TP]; scratch int32[J, 2, QP]
// for the wide path (QP above fgdp_kswv_reg_max_qp()), else unused.
// *path (host memory) receives the path taken: 0 registers, 1 wide.
// ev_start/ev_end are cudaEvent_t or null, recorded on `stream` just
// before and just after the launch (no host time falls between them).
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a negative shape or a wide launch without
// scratch.
extern "C" int fgdp_kswv(const int* q, const int* t, const int* qlen,
                         const int* tlen, int J, int QP, int TP, int a,
                         int b, int o_del, int e_del, int o_ins, int e_ins,
                         int* best, int* te, int* best_row, int* row_max,
                         int* scratch, int* path, void* ev_start,
                         void* ev_end, void* stream) {
  if (J < 0 || QP < 0 || TP < 0) return (int)cudaErrorInvalidValue;
  const KswvParams p{a, b, o_del, e_del, o_ins, e_ins};
  const int K = QP > 0 ? (QP + 31) / 32 : 1;
  const bool wide = K > KSWV_MAX_K;
  if (wide && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  *path = wide ? 1 : 0;
  if (ev_start != nullptr) cudaEventRecord((cudaEvent_t)ev_start, s);
  if (J > 0) {
    if (wide)
      kswv_wide_kernel<<<(J + KSWV_WARPS - 1) / KSWV_WARPS, KSWV_WARPS * 32,
                         0, s>>>(KSWV_ARGS, scratch);
    else
      launch_regs(K, KSWV_ARGS, s);
  }
  if (ev_end != nullptr) cudaEventRecord((cudaEvent_t)ev_end, s);
  return (int)cudaGetLastError();
}
