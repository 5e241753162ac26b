// D10, the sweep's backward phase, for Hopper (sm_90a): every entry of
// the forward phase (D9) extended leftward to its maximal reach, then
// the single-suffix text walk of the entries that narrowed to one
// suffix.
//
// Replaces the JAX package's device loop fgdp_tpu/ops/smem_sweep.py:359
// bwd_entries (its four lax.while_loops :414, :421, :450, :455), which
// the port ran as Python loops of torch ops with a host sync at every
// step. The logic per lane is sweep_bwd.cuh, the rank primitives fm.cuh
// (D1), the packed text window smem_lcp.cuh's.
//
// Design: an ordinary launch, one thread an entry lane; each lane runs
// to its own end, its state in registers (no stack frame). The torch-op
// loops' compaction of stragglers into narrower machines has no
// counterpart: a thread whose lane ended takes no more issue slots.
//
// What bounds it: the longest lane's chain of dependent gathers (two
// 24-byte reads of occ rows a step, then an SA entry and five packed
// text words a walk step); the bytes over the whole batch (48 a step of
// every lane) are tens of MB at most.
#include <cuda_runtime.h>

#include "sweep_bwd.cuh"

#define SWB_THREADS 128

__global__ void __launch_bounds__(SWB_THREADS)
    sweep_bwd_kernel(SweepBwdArgs A) {
  const int t = blockIdx.x * SWB_THREADS + threadIdx.x;
  if (t < A.NL) sweep_bwd_lane(A, t);
}

// The FM-index as fgdp_smem_lcp takes it; codes int32[B, L], lens
// int32[B]; rid, anc, k, s, mi int32[NL], on bool[NL] (flatten_entries'
// lanes); words/nwords/l2ref as fgdp_sweep_fwd's; out_m, out_kf, out_sf
// int32[NL]; work int64[4] zeroed or null; the events, stream and return
// code as fgdp_sweep_fwd's.
extern "C" int fgdp_sweep_bwd(
    const int* occ, long long nblocks, const int* counts, const int* c2,
    const int* sa, long long sa_len, int sentinel_row, int r1_row,
    int cc_r0, int cc_r1, const int* codes, const int* lens, const int* rid,
    const int* anc, const int* k, const int* s, const int* mi,
    const unsigned char* on, const long long* words, long long nwords, int B,
    int L, int NL, int l2ref, int* out_m, int* out_kf, int* out_sf,
    long long* work, void* ev_start, void* ev_end, void* stream) {
  if (B < 0 || L < 0 || NL < 0 || nblocks < 1 || sa_len < 1 || nwords < 1)
    return (int)cudaErrorInvalidValue;
  SweepBwdArgs A{FmView{occ, nblocks, counts, c2, sa, sa_len, sentinel_row,
                        r1_row, cc_r0, cc_r1},
                 codes, lens, rid, anc, k, s, mi, on, words, nwords, B, L,
                 NL, l2ref, out_m, out_kf, out_sf, work};
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)(((long long)NL + SWB_THREADS - 1) / SWB_THREADS);
  fgdp_record(ev_start, st);
  if (NL > 0) sweep_bwd_kernel<<<blocks, SWB_THREADS, 0, st>>>(A);
  fgdp_record(ev_end, st);
  return (int)cudaGetLastError();
}
