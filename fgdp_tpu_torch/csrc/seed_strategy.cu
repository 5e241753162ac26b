// K3 (the seed strategy) for Hopper (sm_90a): forward-only seeding with
// an interval cap, every anchor of every read.
//
// Replaces the JAX package's device loop fgdp_tpu/ops/smem.py:872
// seed_strategy (D4: the lax.while_loop of _seed_strategy_loop), which
// the port ran as a Python loop of torch ops, testing for live lanes on
// the host every 8 steps. The logic per read is seed_strategy.cuh, the
// rank primitives fm.cuh (D1).
//
// Design: an ordinary launch, one thread a read (a grid-stride loop over
// the reads); each thread runs its read's steps to the read's own end:
// the lockstep loop's test only ends the loop once no lane is live, and
// a finished lane's step changes nothing (seed_strategy.cuh), so no
// barrier is needed.
//
// What bounds it: the slowest read's serial chain of steps (up to about
// one a base pair and one a restart), each the latency of two dependent
// 96-byte occ-row gathers; the bytes over the whole batch (two rows a
// step of every read) are tens of MB, well under a millisecond at the
// card's memory rate. The design runs no barrier and no host test, so a
// read's chain is the only serial part.
#include <cuda_runtime.h>

#include "seed_strategy.cuh"

#define K3_THREADS 64

__global__ void __launch_bounds__(K3_THREADS)
    seed_strategy_kernel(K3Args A) {
  for (int rd = blockIdx.x * blockDim.x + threadIdx.x; rd < A.B;
       rd += gridDim.x * blockDim.x)
    k3_read(A, rd);
}

// The FM-index as fgdp_smem_lcp takes it; codes int32[B, L], lens
// int32[B], active bool[B]; out_m/n/k/s int32[B, S] zeroed, count
// int32[B], overflow bool[B]; work int64[4] zeroed or null. The events
// and the return code as fgdp_smem_lcp's (no cooperative launch here).
extern "C" int fgdp_seed_strategy(
    const int* occ, long long nblocks, const int* counts, const int* c2,
    const int* sa, long long sa_len, int sentinel_row, int r1_row,
    int cc_r0, int cc_r1, const int* codes, const int* lens,
    const unsigned char* active, int B, int L, int max_intv, int msl, int S,
    int* out_m, int* out_n, int* out_k, int* out_s, int* count,
    unsigned char* overflow, long long* work, void* ev_start, void* ev_end,
    void* stream) {
  if (B < 0 || L < 0 || S < 0 || nblocks < 1 || sa_len < 1)
    return (int)cudaErrorInvalidValue;
  K3Args A{FmView{occ, nblocks, counts, c2, sa, sa_len, sentinel_row,
                  r1_row, cc_r0, cc_r1},
           codes, lens, active, B, L, max_intv, msl,
           SeedRows{out_m, out_n, out_k, out_s, S}, count, overflow, work};
  cudaStream_t s = (cudaStream_t)stream;
  if (ev_start != nullptr) cudaEventRecord((cudaEvent_t)ev_start, s);
  if (B > 0) {
    const int blocks = (B + K3_THREADS - 1) / K3_THREADS;
    seed_strategy_kernel<<<blocks, K3_THREADS, 0, s>>>(A);
  }
  if (ev_end != nullptr) cudaEventRecord((cudaEvent_t)ev_end, s);
  return (int)cudaGetLastError();
}
