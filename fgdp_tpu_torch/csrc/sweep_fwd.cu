// D9, the sweep's forward phase, for Hopper (sm_90a): every anchor of
// every lane (K1: a lane a read, self-restarting anchors; K2: one anchor
// a lane) extended forward to its end, its prev-stack entries appended
// to the lane's entry row.
//
// Replaces the JAX package's device loop fgdp_tpu/ops/smem_sweep.py:129
// fwd_sweep (its lax.while_loop :300), which the port ran as a Python
// loop of torch ops with a host sync at every step. The logic per lane
// is sweep_fwd.cuh, the rank primitives fm.cuh (D1), the packed text
// window smem_lcp.cuh's.
//
// Design: an ordinary launch, one thread a lane; each lane runs its own
// steps to its own end (no barrier: the lanes are independent), its
// state in registers (no stack frame: every run-time character select
// is a register select), its entries written straight to its rows. 32
// threads a block, so that K1's 4,096 lanes spread over 128 blocks,
// nearly one an SM of the 132.
//
// What bounds it: the busiest lane's serial chain of steps, each the
// latency of a dependent gather of two 96-byte occ rows (a walk step:
// an SA entry, then five packed text words); the bytes over the whole
// batch are a few MB.
#include <cuda_runtime.h>

#include "sweep_fwd.cuh"

#define SWF_THREADS 32

template <bool RESTART, bool WALK>
__global__ void __launch_bounds__(SWF_THREADS)
    sweep_fwd_kernel(SweepFwdArgs A) {
  const int t = blockIdx.x * SWF_THREADS + threadIdx.x;
  if (t < A.NL) sweep_fwd_lane<RESTART, WALK>(A, t);
}

// The FM-index as fgdp_smem_lcp takes it; codes int32[B, L], lens
// int32[B]; rid, x0, min_intv int32[NL], active bool[NL]; words/nwords
// the packed reference (int64 words holding uint32), l2ref its length
// (2 n_ref); E the entries a lane, prev_cap the pushes an anchor;
// restart, walk 0 or 1; em/en/ek/es int32[NL, E] zeroed, ecount
// int32[NL], povf/eovf bool[NL]; work int64[4] zeroed or null. Records
// ev_start/ev_end (CUDA events, or null) around the launch on `stream`.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for bad sizes.
extern "C" int fgdp_sweep_fwd(
    const int* occ, long long nblocks, const int* counts, const int* c2,
    const int* sa, long long sa_len, int sentinel_row, int r1_row,
    int cc_r0, int cc_r1, const int* codes, const int* lens, const int* rid,
    const int* x0, const int* min_intv, const unsigned char* active,
    const long long* words, long long nwords, int B, int L, int NL, int E,
    int prev_cap, int l2ref, int restart, int walk, int* em, int* en,
    int* ek, int* es, int* ecount, unsigned char* povf, unsigned char* eovf,
    long long* work, void* ev_start, void* ev_end, void* stream) {
  if (B < 0 || L < 0 || NL < 0 || E < 0 || prev_cap < 0 || nblocks < 1 ||
      sa_len < 1 || nwords < 1)
    return (int)cudaErrorInvalidValue;
  SweepFwdArgs A{FmView{occ, nblocks, counts, c2, sa, sa_len, sentinel_row,
                        r1_row, cc_r0, cc_r1},
                 codes, lens, rid, x0, min_intv, active, words, nwords, B, L,
                 NL, E, prev_cap, l2ref, em, en, ek, es, ecount, povf, eovf,
                 work};
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)(((long long)NL + SWF_THREADS - 1) / SWF_THREADS);
  if (ev_start != nullptr) cudaEventRecord((cudaEvent_t)ev_start, s);
  if (NL > 0) {
    if (restart && walk)
      sweep_fwd_kernel<true, true><<<blocks, SWF_THREADS, 0, s>>>(A);
    else if (restart)
      sweep_fwd_kernel<true, false><<<blocks, SWF_THREADS, 0, s>>>(A);
    else if (walk)
      sweep_fwd_kernel<false, true><<<blocks, SWF_THREADS, 0, s>>>(A);
    else
      sweep_fwd_kernel<false, false><<<blocks, SWF_THREADS, 0, s>>>(A);
  }
  if (ev_end != nullptr) cudaEventRecord((cudaEvent_t)ev_end, s);
  return (int)cudaGetLastError();
}
