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
// Design: one warp per job, one job a block, the job's DP row in
// registers (kswv.cuh, kswv_job_regs<K>): lane l holds K consecutive
// query columns, K = ceil(QP / 32) a template parameter (K = 5 at the
// mates' QP of 160; every K up to KSWV_MAX_K = 8, QP <= 256, is
// instantiated), and the lanes run an anti-diagonal wavefront: at step i
// lane l computes row i - l, taking the diagonal H, F's carry and the
// row max from lane l - 1's previous step by one __shfl_up_sync each
// (and the next step's target code a step ahead). So a step waits for
// one round of shuffles, then a few DPX max-adds (no scan, no warp
// reduction); the row max of row r is complete in lane 31 after step
// r + 31 and one broadcast from it at step r + 32 carries the best/te
// test and the row max store (32 rows at a time). Each lane keeps its
// last 32 rows of H in a ring in shared memory (32 x K x 32 ints a warp:
// 20 KB at K = 5, indexed [step % 32][column][lane], so a step's stores
// are free of bank conflicts at one uniform address); the best row is
// copied from it when the decision arrives. A job runs min(tlen, TP) +
// 31 steps, in chunks of 32 (the target's codes and the row maxima move
// once a chunk); an empty job (the padding of the job bucket) leaves at
// once.
//
// Width and blocks: a job takes the whole warp (32 lanes) at every QP,
// and a block holds one warp. pe_scale's launches are 1,280 jobs (1,263
// live) of QP 160: 1,280 one-warp blocks of 21 KB of shared memory (the
// ring and the block's reserve) fit ten to an SM, so the launch is one
// wave of 9.7 warps an SM on the 132 SMs, placed a warp at a time
// (blocks of four warps would be 320, two or three an SM). Half-warp jobs
// would halve the units the SMs' schedulers share (640 warps for 528
// schedulers: one or two each) and double the columns a lane holds.
// Scores that do not fit a signed byte (the profile's bytes) and launches
// whose QP is above 32 KSWV_MAX_K take the wide path (kswv_job_wide): the
// row's H and E in the job's scratch rows in global memory, 32 columns
// at a time. The C entry point chooses from QP and the scores before the
// launch and reports the path. A 16-bit variant (sm_90's s16x2 max-adds,
// two jobs a register) is not built.
//
// What bounds it: a warp step's dependent chain (its shuffles, then the
// carry's 3-way max, H's max-add, the qlen cap and the row max) and the
// instructions the SM's schedulers issue for the 9.7 warps an SM (about
// 80 a step at K = 5 on the common path: a byte permute, four max-adds,
// a cap, a subtract and a max a lane column, the step's six shuffles,
// five ring stores and the decision; python -m fgdp_tpu_torch.probes.sass).
// A cell of _forward is 24 int32 operations (probes.KSWV_OPS_PER_CELL),
// the bound's count; the bytes are the inputs read once and the outputs
// written once: the best row and the row maxima dominate.
#include <cuda_runtime.h>

#include "kswv.cuh"

#define KSWV_WARPS 4   // jobs (warps) per block of the wide path

// the ring's bytes a job (one warp, one block) at K columns a lane
static int ring_bytes(int K) { return KSWV_RING * K * 32 * (int)sizeof(int); }

template <int K>
__global__ void __launch_bounds__(32)
    kswv_regs_kernel(const int* __restrict__ q, const int* __restrict__ t,
                     const int* __restrict__ qlen,
                     const int* __restrict__ tlen, int J, int QP, int TP,
                     KswvParams p, int* __restrict__ best,
                     int* __restrict__ te, int* __restrict__ best_row,
                     int* __restrict__ row_max) {
  extern __shared__ int ring[];
  const int j = blockIdx.x;
  WarpLanes L;
  int b, e;
  kswv_job_regs<K>(q + (long long)j * QP, t + (long long)j * TP, QP, TP,
                   qlen[j], tlen[j], p, L, ring,
                   best_row + (long long)j * QP, row_max + (long long)j * TP,
                   b, e);
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
#define KSWV_LAUNCH(k)                                                   \
  case k:                                                                \
    kswv_regs_kernel<k><<<J, 32, ring_bytes(k), s>>>(KSWV_ARGS);         \
    break;
  switch (K) {
    KSWV_LAUNCH(1) KSWV_LAUNCH(2) KSWV_LAUNCH(3) KSWV_LAUNCH(4)
    KSWV_LAUNCH(5) KSWV_LAUNCH(6) KSWV_LAUNCH(7) KSWV_LAUNCH(8)
  }
#undef KSWV_LAUNCH
}

// the widest QP the register path takes
extern "C" int fgdp_kswv_reg_max_qp() { return 32 * KSWV_MAX_K; }

// 1 where a launch at QP with match score a and mismatch penalty b takes
// the wide path (and needs its scratch), else 0
extern "C" int fgdp_kswv_wide(int QP, int a, int b) {
  const KswvParams p{a, b, 0, 0, 0, 0};
  return QP > 32 * KSWV_MAX_K || !kswv_bytes_ok(p) ? 1 : 0;
}

// q int32[J, QP], t int32[J, TP], qlen/tlen int32[J]; best/te int32[J],
// best_row int32[J, QP], row_max int32[J, TP]; scratch int32[J, 2, QP]
// for the wide path (where fgdp_kswv_wide(QP, a, b)), else unused.
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
  const bool wide = K > KSWV_MAX_K || !kswv_bytes_ok(p);
  if (wide && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  *path = wide ? 1 : 0;
  fgdp_record(ev_start, s);
  if (J > 0) {
    if (wide)
      kswv_wide_kernel<<<(J + KSWV_WARPS - 1) / KSWV_WARPS, KSWV_WARPS * 32,
                         0, s>>>(KSWV_ARGS, scratch);
    else
      launch_regs(K, KSWV_ARGS, s);
  }
  fgdp_record(ev_end, s);
  return (int)cudaGetLastError();
}
