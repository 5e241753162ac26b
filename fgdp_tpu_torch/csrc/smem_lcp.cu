// K1 of the LCP seeding engine for Hopper (sm_90a): every read's SMEMs
// by one pass of backward extension and LCP-tree ascent.
//
// Replaces the JAX package's device loop fgdp_tpu/ops/smem_lcp.py:50
// smem_all_lcp (D2: the lax.while_loops of its EXT, WALK and SHR waves,
// :254-279, and the straggler cascade around them), which the port ran
// as a Python loop of torch ops with a host sync at every loop test. The
// logic per lane is smem_lcp.cuh, the wave machine seed_waves.cuh, the
// rank primitives fm.cuh (D1).
//
// Design: one cooperative launch for the whole machine, one thread a
// read. A thread keeps its lanes' state (l, r, lo, hi, pos, mode, seed
// count and flags) in registers, R lanes a thread (R = 1 while the reads
// fit in the resident threads, else 4 or 16, lanes t R .. t R + R - 1)
// and appends its seeds to the read's own SeedBatch row. Before every
// step the machine's mode counts are a block reduction, one atomicAdd a
// block into one of three counter sets and one grid barrier
// (CoopGrid), so every thread takes the same exit; the cascade's stable
// compaction is an exclusive scan of the threads' live counts across the
// grid. The grid is the fewest blocks that hold the lanes, within what
// cudaOccupancyMaxActiveBlocksPerMultiprocessor lets be resident; a
// launch that cannot be resident returns
// cudaErrorCooperativeLaunchTooLarge and the wrapper raises.
//
// What bounds it: the serial chain of steps, each a grid barrier (a few
// microseconds) and the slowest lane's dependent gathers: an EXT step two
// occ rows of 96 bytes, a SHR step two tree rows of 16 bytes, a WALK step
// an SA entry and up to 64 read codes and 5 packed text words. The bytes
// those gathers move over a batch of thousands of reads are a few MB,
// microseconds at the card's memory rate; the steps (hundreds a batch)
// and their barriers, and the latency of each step's gathers, set the
// time. The
// design keeps every step on the card (no launch and no host sync a
// step) and gathers only what a lane in the wave's mode needs.
#include <cuda_runtime.h>

#include "smem_lcp.cuh"

#define LCP_THREADS 64

template <int R>
__global__ void __launch_bounds__(LCP_THREADS)
    smem_lcp_kernel(LcpArgs A, int max_rounds, int* sets, int* blk) {
  CoopGrid g{sets, blk, 0};
  LaneArray<LcpLane, R> ln;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < R; ++i) lcp_lane_init(A, ln[i], t * R + i);
  lcp_machine(A, g, ln, max_rounds);
  for (int i = 0; i < R; ++i) lcp_lane_finish(A, ln[i]);
  if (A.work != nullptr && t == 0) A.work[1] = g.step;
}

template <int R>
static int launch(LcpArgs& A, int max_rounds, int* sets, int* blk,
                  cudaStream_t s) {
  int blocks = 0;
  const int rc = coop_blocks(smem_lcp_kernel<R>, LCP_THREADS, A.B, R,
                             &blocks);
  if (rc) return rc;
  void* args[] = {&A, &max_rounds, &sets, &blk};
  return (int)cudaLaunchCooperativeKernel((void*)smem_lcp_kernel<R>, blocks,
                                          LCP_THREADS, args, 0, s);
}

// The lanes a thread holds at a launch of B reads: 1, 4 or 16 (the
// fewest that fit in the resident threads), or 0 when none does.
static int lanes_per_thread(int B, int* blocks) {
  if (coop_blocks(smem_lcp_kernel<1>, LCP_THREADS, B, 1, blocks) == 0)
    return 1;
  if (coop_blocks(smem_lcp_kernel<4>, LCP_THREADS, B, 4, blocks) == 0)
    return 4;
  if (coop_blocks(smem_lcp_kernel<16>, LCP_THREADS, B, 16, blocks) == 0)
    return 16;
  return 0;
}

// The grid a launch of B reads takes: grid[0] blocks of grid[1]
// threads. Returns the lanes a thread holds, or 0 when they cannot all
// be resident (grid[0] is then the blocks at 16 lanes a thread).
extern "C" int fgdp_smem_lcp_grid(int B, int* grid) {
  grid[1] = LCP_THREADS;
  return lanes_per_thread(B > 0 ? B : 1, grid);
}

// the most blocks a launch of B reads uses (the size of `blk`)
extern "C" int fgdp_smem_lcp_max_blocks(int B) {
  return (B + LCP_THREADS - 1) / LCP_THREADS + 1;
}

// occ int32[nblocks, 24], counts int32[5], c2 int32[17], sa int32[sa_len]
// (the DeviceFMIndex); tree int32[N + 1, 4], isa int32[N]; codes
// int32[B, L], lens int32[B], active bool[B]; words int64[nwords] (the
// reference's packed words, DeviceReference.codes16); out_m/n/k/s
// int32[B, S] zeroed, count int32[B], overflow bool[B]; sets int32[12]
// zeroed, blk int32[fgdp_smem_lcp_max_blocks(B)]; work int64[4] zeroed
// (seed_waves.cuh's counters) or null. ev_start/ev_end are cudaEvent_t or
// null, recorded on `stream` just before and just after the launch.
// Returns cudaGetLastError() after the launch, the launch's own error
// (cudaErrorCooperativeLaunchTooLarge when the lanes cannot all be
// resident), or cudaErrorInvalidValue for a bad shape.
extern "C" int fgdp_smem_lcp(
    const int* occ, long long nblocks, const int* counts, const int* c2,
    const int* sa, long long sa_len, int sentinel_row, int r1_row,
    int cc_r0, int cc_r1, const int* tree, const int* isa, const int* codes,
    const int* lens, const unsigned char* active, const long long* words,
    long long nwords, int B, int L, int N, int l2ref, int msl, int S,
    int max_rounds, int* out_m, int* out_n, int* out_k, int* out_s,
    int* count, unsigned char* overflow, int* sets, int* blk,
    long long* work, void* ev_start, void* ev_end, void* stream) {
  if (B < 0 || L < 0 || N < 1 || S < 0 || nblocks < 1 || sa_len < 1 ||
      nwords < 1)
    return (int)cudaErrorInvalidValue;
  LcpArgs A{FmView{occ, nblocks, counts, c2, sa, sa_len, sentinel_row,
                   r1_row, cc_r0, cc_r1},
            tree, isa, codes, lens, active, words, nwords, B, L, N, l2ref,
            msl, SeedRows{out_m, out_n, out_k, out_s, S}, count, overflow,
            work};
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  const int R = B > 0 ? lanes_per_thread(B, &blocks) : 1;
  if (R == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (ev_start != nullptr) cudaEventRecord((cudaEvent_t)ev_start, s);
  int rc = 0;
  if (B > 0) {
    if (R == 1)
      rc = launch<1>(A, max_rounds, sets, blk, s);
    else if (R == 4)
      rc = launch<4>(A, max_rounds, sets, blk, s);
    else
      rc = launch<16>(A, max_rounds, sets, blk, s);
  }
  if (ev_end != nullptr) cudaEventRecord((cudaEvent_t)ev_end, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
