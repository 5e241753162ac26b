// Banded-SW extension kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fgdp_tpu/ops/sw_pallas.py (_kernel, launched by
// sw_extend_pallas): bwa ksw_extend2 over a batch of jobs, with the
// per-lane band clamp, z-drop, zero-row death and early exit, giving
// score, qle, tle, gtle, gscore and max_off per job.
//
// Design: one warp per job (sw_extend.cuh). Lane l owns K consecutive
// columns of the job's band state, K = ceil((QP + 2) / 32) a template
// parameter (K = 5 at the main path's QP = 151; every K up to
// SW_MAX_K = 8, QP <= 254, is instantiated). The H/E band state and the
// query codes stay in registers for the whole job; the target is read 32
// codes at a time, one per lane, and broadcast row by row with a shuffle.
// Each row is computed as the TPU kernel computes it, warp-wide: the
// per-column terms in the lane's registers, the in-row F term as an
// in-lane running max plus a 5-step __shfl_up_sync scan of the lane
// totals, the row max and its last argmax and the new band's ends as
// __reduce_max_sync / __reduce_min_sync, the shifted H by one
// __shfl_up_sync. The per-job scalars are warp-uniform, so the warp
// leaves its row loop together, at death or at min(tlen, TP); an empty
// job leaves at once. Warps take jobs from the last to the first: the
// caller sorts jobs by ascending query length, so the longest jobs start
// first and the short ones fill in behind them.
//
// What bounds it: issuing the row loop's instructions. A row costs the
// same warp instructions whatever its band width: about 52 SASS
// instructions per column a lane holds (compares and selects of the band
// masks, VIADDMNMX/VIMNMX for the recurrence) plus about 112 for the
// shuffles, reductions and per-job scalars, 350 at K = 5
// (python -m fgdp_tpu_torch.probes.sass). A warp's lanes do useful work
// in proportion to end - beg over 32 K (about 41% on the main path's
// jobs). There is no band state in device memory: the bytes are the
// inputs read once and the outputs.
#include <cuda_runtime.h>

#include "sw_extend.cuh"

#define SW_WARPS 4   // jobs (warps) per block

template <int K>
__global__ void __launch_bounds__(SW_WARPS * 32)
    sw_extend_kernel(const int* __restrict__ query,
                     const int* __restrict__ target,
                     const int* __restrict__ qlen,
                     const int* __restrict__ tlen,
                     const int* __restrict__ h0, int J, int QP, int TP,
                     int w, SWParamsC p, int* __restrict__ out,
                     long long* __restrict__ cells,
                     long long* __restrict__ rows) {
  const int warp = blockIdx.x * SW_WARPS + (threadIdx.x >> 5);
  if (warp >= J) return;   // whole warps: every shuffle sees 32 lanes
  const int j = J - 1 - warp;
  WarpLanes L;
  int res[SW_OUTS];
  const long long c = sw_extend_job<K>(
      query + (long long)j * QP, target + (long long)j * TP, QP, TP, qlen[j],
      tlen[j], h0[j], w, p, L, res);
  if (L.lane() == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) out[(long long)k * J + j] = res[k];
    if (cells != nullptr) cells[j] = c;
    if (rows != nullptr) rows[j] = res[6];
  }
}

template <int K>
static void launch(const int* query, const int* target, const int* qlen,
                   const int* tlen, const int* h0, int J, int QP, int TP,
                   int w, const SWParamsC& p, int* out, long long* cells,
                   long long* rows, cudaStream_t stream) {
  const int blocks = (J + SW_WARPS - 1) / SW_WARPS;
  sw_extend_kernel<K><<<blocks, SW_WARPS * 32, 0, stream>>>(
      query, target, qlen, tlen, h0, J, QP, TP, w, p, out, cells, rows);
}

// the instantiation for K columns a lane (1 <= K <= SW_MAX_K)
static void launch_k(int K, const int* query, const int* target,
                     const int* qlen, const int* tlen, const int* h0, int J,
                     int QP, int TP, int w, const SWParamsC& p, int* out,
                     long long* cells, long long* rows, cudaStream_t s) {
  static_assert(SW_MAX_K == 8, "instantiate every K up to SW_MAX_K");
#define SW_LAUNCH(k)                                                       \
  case k:                                                                  \
    launch<k>(query, target, qlen, tlen, h0, J, QP, TP, w, p, out, cells, \
              rows, s);                                                    \
    break;
  switch (K) {
    SW_LAUNCH(1) SW_LAUNCH(2) SW_LAUNCH(3) SW_LAUNCH(4)
    SW_LAUNCH(5) SW_LAUNCH(6) SW_LAUNCH(7) SW_LAUNCH(8)
  }
#undef SW_LAUNCH
}

// query int32[J, QP], target int32[J, TP], qlen/tlen/h0 int32[J];
// out int32[6, J]; cells and rows int64[J] or null (the DP cells and the
// rows each job computed); ev_start/ev_end cudaEvent_t or null, recorded
// on `stream` just before and just after the launch (no host time falls
// between them). Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for QP above 32 * SW_MAX_K - 2.
extern "C" int fgdp_sw_extend(const int* query, const int* target,
                              const int* qlen, const int* tlen,
                              const int* h0, int J, int QP, int TP, int w,
                              int o_del, int e_del, int o_ins, int e_ins,
                              int zdrop, int end_bonus, int mat_max,
                              int mat_mis, int mat_amb, int* out,
                              long long* cells, long long* rows,
                              void* ev_start, void* ev_end, void* stream) {
  SWParamsC p{o_del, e_del, o_ins, e_ins, zdrop, end_bonus, mat_max,
              mat_mis, mat_amb};
  const int K = (QP + 2 + 31) / 32;
  if (QP < 0 || K > SW_MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  fgdp_record(ev_start, s);
  if (J > 0) launch_k(K, query, target, qlen, tlen, h0, J, QP, TP, w, p,
                      out, cells, rows, s);
  fgdp_record(ev_end, s);
  return (int)cudaGetLastError();
}
