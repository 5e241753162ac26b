// Banded-SW extension kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fgdp_tpu/ops/sw_pallas.py (_kernel, launched by
// sw_extend_pallas): bwa ksw_extend2 over a batch of jobs, with the
// per-lane band clamp, z-drop, zero-row death and early exit, giving
// score, qle, tle, gtle, gscore and max_off per job.
//
// Design: one thread per job, running the rows of its band in order
// (sw_extend.cuh). The H/E band state, int32[QP+2] per job, lives in a
// global scratch laid out job-minor, so the 32 threads of a warp touch
// 32 neighbouring words at each step. A thread stops at its own dead
// row or at tlen; the caller sorts jobs by query length, so a warp's
// threads end close together.
//
// What bounds it: the DP cells. Each cell is ~20 int32 operations and
// two scratch reads + two writes; the cells a job computes depend on
// its band and on when it dies, so the bound is counted from the run's
// data (the `cells` output). At the main path's shapes the input and
// output bytes are a few tens of MB; the scratch traffic and the
// integer work per cell are what this simple design pays for.
#include <cuda_runtime.h>

#include "sw_extend.cuh"

__global__ void sw_extend_kernel(const int* __restrict__ query,
                                 const int* __restrict__ target,
                                 const int* __restrict__ qlen,
                                 const int* __restrict__ tlen,
                                 const int* __restrict__ h0, int J, int QP,
                                 int TP, int w, SWParamsC p, int* eh_h,
                                 int* eh_e, int* __restrict__ out,
                                 long long* __restrict__ cells) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  int res[6];
  long long c = sw_extend_job(query + (long long)j * QP,
                              target + (long long)j * TP, QP, TP, qlen[j],
                              tlen[j], h0[j], w, p, eh_h + j, eh_e + j,
                              (long long)J, res);
  for (int k = 0; k < 6; ++k) out[(long long)k * J + j] = res[k];
  if (cells != nullptr) cells[j] = c;
}

// query int32[J, QP], target int32[J, TP], qlen/tlen/h0 int32[J];
// eh_h/eh_e int32[(QP+2) * J] scratch; out int32[6, J]; cells int64[J]
// or null. Launches on `stream` and returns cudaGetLastError().
extern "C" int fgdp_sw_extend(const int* query, const int* target,
                              const int* qlen, const int* tlen,
                              const int* h0, int J, int QP, int TP, int w,
                              int o_del, int e_del, int o_ins, int e_ins,
                              int zdrop, int end_bonus, int mat_max,
                              int mat_mis, int mat_amb, int* eh_h,
                              int* eh_e, int* out, long long* cells,
                              void* stream) {
  SWParamsC p{o_del, e_del, o_ins, e_ins, zdrop, end_bonus, mat_max,
              mat_mis, mat_amb};
  if (J > 0) {
    const int threads = 128;
    const int blocks = (J + threads - 1) / threads;
    sw_extend_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        query, target, qlen, tlen, h0, J, QP, TP, w, p, eh_h, eh_e, out,
        cells);
  }
  return (int)cudaGetLastError();
}
