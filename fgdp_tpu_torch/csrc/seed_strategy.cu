// K3 (the seed strategy) for Hopper (sm_90a): forward-only seeding with
// an interval cap, every anchor of every read.
//
// Replaces the JAX package's device loop fgdp_tpu/ops/smem.py:872
// seed_strategy (D4: the lax.while_loop of _seed_strategy_loop), which
// the port ran as a Python loop of torch ops, testing for live lanes on
// the host every 8 steps. The logic per read is seed_strategy.cuh, the
// rank primitives fm.cuh (D1).
//
// Design: an ordinary launch, a 16-lane group (half a warp) a read, a
// grid-stride loop over the reads; each group runs its read's steps to
// the read's own end: the lockstep loop's test only ends the loop once
// no lane is live, and a finished lane's step changes nothing
// (seed_strategy.cuh), so no barrier is needed. The read's state is the
// same in every lane of its group, so a group never diverges (two reads
// of a warp may). An extension step's two rows are read by the group at
// once: lane g reads its row's packed words (16 bytes, one address for
// the row's 8 lanes) and one count, computes one of the 16 ranks with
// two __popc, and the group gathers the 16 by shuffles (fm.cuh,
// fm_forward_extend2_group); every character select is a register
// select, so the kernel keeps no stack frame. The read's codes are read
// once, into the group's bytes of shared memory, or read where they lie
// when a batch's L is too long for eight buffers in 48 KB. Eight groups a
// block (128 threads); the grid is as many blocks as the reads need, at
// most what cudaOccupancyMaxActiveBlocksPerMultiprocessor lets be
// resident on every SM: 4,096 reads are 2,048 warps, 3.9 blocks of 4
// warps on each of the 132 SMs.
//
// 16 lanes, not 8: one rank a lane, so the step's 16 ranks need one round
// of shuffles and two __popc a lane; at 8 lanes a lane takes the rank of
// both rows (or a second round of shuffles), and a warp holds four reads
// whose restarts and ends diverge instead of two.
//
// What bounds it: the slowest read's serial chain of steps (up to about
// one a base pair and one a restart), each the latency of the dependent
// gather of two 96-byte occ rows (probes.chase times it alone) plus the
// group's ranks and shuffles; the bytes over the whole batch (two rows a
// step of every read) are tens of MB, well under a millisecond at the
// card's memory rate.
#include <cuda_runtime.h>

#include "seed_strategy.cuh"

#define K3_GROUPS 8   // reads (groups) a block

// The group policy on the card: the 16 lanes of a half warp.
struct K3Group : FmHalfWarp {
  // the read's codes into the group's buffer, clamped to -1..4
  __host__ __device__ void stage(signed char* buf, const int* row,
                                 int L) const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);   // the group's last read of the buffer is done
    for (int u = g; u < L; u += FM_GROUP) buf[u] = k3_code8(__ldg(row + u));
    __syncwarp(mask);
#endif
  }
};

__global__ void __launch_bounds__(K3_GROUPS * FM_GROUP)
    seed_strategy_kernel(K3Args A, int staged) {
  extern __shared__ signed char k3_buf[];
  const int gb = threadIdx.x / FM_GROUP;
  const K3Group grp{{(int)(threadIdx.x & (FM_GROUP - 1)),
                     0xFFFFu << (threadIdx.x & 16)}};
  signed char* buf = staged ? k3_buf + (long long)gb * A.L : nullptr;
  for (int rd = blockIdx.x * K3_GROUPS + gb; rd < A.B;
       rd += gridDim.x * K3_GROUPS)
    k3_read(A, rd, grp, buf);
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
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the groups' code buffers while eight fit in a block's default 48 KB of
  // shared memory (L up to 6,144); longer reads are read where they lie
  const int staged = (long long)K3_GROUPS * L <= 48 * 1024;
  const int threads = K3_GROUPS * FM_GROUP;
  const int smem = staged ? K3_GROUPS * L : 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seed_strategy_kernel,
                                                threads, smem);
  const long long need = ((long long)B + K3_GROUPS - 1) / K3_GROUPS;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = (int)(need < most ? need : most);
  fgdp_record(ev_start, s);
  if (B > 0)
    seed_strategy_kernel<<<blocks, threads, smem, s>>>(A, staged);
  fgdp_record(ev_end, s);
  return (int)cudaGetLastError();
}
