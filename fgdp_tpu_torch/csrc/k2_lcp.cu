// K2 of the LCP seeding engine for Hopper (sm_90a): re-seeding of long
// low-occurrence K1 SMEMs by ISA jump, LCP-tree ascent, forward
// extension and a backward pass.
//
// Replaces the JAX package's device loop fgdp_tpu/ops/smem_k2lcp.py:105
// k2_reseed_lcp (D3: the lax.while_loops of its two ascents, its forward
// extension and the EXT/SHR waves of its backward pass), which the port
// ran as a Python loop of torch ops with a host sync at every loop test.
// The logic per lane is k2_lcp.cuh, the wave machine seed_waves.cuh, the
// rank primitives fm.cuh (D1). merge_lane_seeds, which scatters the lane
// rows into the reads' SeedBatch rows, stays torch ops.
//
// Design: one cooperative launch, one thread a job (NK = B k2_per_read
// k2_scale lanes, R a thread as in smem_lcp.cu). A thread first runs its
// lane's ascents and forward extension to their own ends (no barrier:
// they are independent per lane), then the backward pass under the same
// wave test as K1 (GridBar, seed_waves.cuh: the counts ride on one
// hand-written grid barrier a step), appending to the lane's LaneSeeds
// row of sj_cap slots.
//
// What bounds it: the slowest lane's serial chain (up to ascent_cap tree
// steps of two 16-byte rows each way, forward steps of two 96-byte occ
// rows) and then the backward pass's steps, each a grid barrier and the
// latency of its gathers; the bytes over the whole batch are a few MB.
// The design keeps every step on the card and lets each lane run its
// per-lane loops without waiting for the others.
#include <cuda_runtime.h>

#include "k2_lcp.cuh"

#define K2_THREADS 64

template <int R>
__global__ void __launch_bounds__(K2_THREADS)
    k2_lcp_kernel(K2Args A, int max_rounds, unsigned long long* slots,
                  int* blk, int narrow) {
  GridBar g{slots, blk, nullptr, narrow != 0};
  LaneArray<K2Lane, R> ln;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < R; ++i) k2_lane_init(A, ln[i], t * R + i);
  k2_machine(A, g, ln, max_rounds);
  for (int i = 0; i < R; ++i) k2_lane_finish(A, ln[i]);
  if (A.work != nullptr && t == 0) A.work[1] = g.step;
}

template <int R>
static int launch(K2Args& A, int max_rounds, unsigned long long* slots,
                  int* blk, cudaStream_t s) {
  int blocks = 0;
  const int rc = coop_blocks(k2_lcp_kernel<R>, K2_THREADS, A.NK, R, &blocks);
  if (rc) return rc;
  int narrow = (A.NK < SEED_NARROW_LANES && blocks < (1 << 13)) ? 1 : 0;
  void* args[] = {&A, &max_rounds, &slots, &blk, &narrow};
  return (int)cudaLaunchCooperativeKernel((void*)k2_lcp_kernel<R>, blocks,
                                          K2_THREADS, args, 0, s);
}

static int lanes_per_thread(int NK, int* blocks) {
  if (coop_blocks(k2_lcp_kernel<1>, K2_THREADS, NK, 1, blocks) == 0)
    return 1;
  if (coop_blocks(k2_lcp_kernel<4>, K2_THREADS, NK, 4, blocks) == 0)
    return 4;
  if (coop_blocks(k2_lcp_kernel<16>, K2_THREADS, NK, 16, blocks) == 0)
    return 16;
  return 0;
}

// The grid a launch of NK jobs takes: grid[0] blocks of grid[1]
// threads. Returns the lanes a thread holds, or 0 when they cannot all
// be resident (grid[0] is then the blocks at 16 lanes a thread).
extern "C" int fgdp_k2_lcp_grid(int NK, int* grid) {
  grid[1] = K2_THREADS;
  return lanes_per_thread(NK > 0 ? NK : 1, grid);
}

// the most blocks a launch of NK jobs uses (the size of `blk`)
extern "C" int fgdp_k2_lcp_max_blocks(int NK) {
  return (NK + K2_THREADS - 1) / K2_THREADS + 1;
}

// The FM-index, tree and isa as fgdp_smem_lcp takes them; codes
// int32[B, L], lens int32[B]; k_read, job_x, job_mi, job_pos, job_d0
// int32[NK], k_on bool[NK]; out_m/n/k/s int32[NK, sj_cap] zeroed, count
// int32[NK], overflow bool[NK] (the lane's seeds, either ascent's step
// cap, or a backward pass still live at max_rounds); slots int64[6]
// zeroed, blk int32[fgdp_k2_lcp_max_blocks(NK)]; work int64[4] or null;
// the events and the return code as fgdp_smem_lcp's (NK above
// SEED_MAX_LANES is cudaErrorInvalidValue).
extern "C" int fgdp_k2_lcp(
    const int* occ, long long nblocks, const int* counts, const int* c2,
    const int* sa, long long sa_len, int sentinel_row, int r1_row,
    int cc_r0, int cc_r1, const int* tree, const int* isa, const int* codes,
    const int* lens, const int* k_read, const int* job_x, const int* job_mi,
    const int* job_pos, const int* job_d0, const unsigned char* k_on, int NK,
    int L, int N, int l2ref, int msl, int sj_cap, int ascent_cap,
    int max_rounds, int* out_m, int* out_n, int* out_k, int* out_s,
    int* count, unsigned char* overflow, unsigned long long* slots, int* blk,
    long long* work, void* ev_start, void* ev_end, void* stream) {
  if (NK < 0 || NK > SEED_MAX_LANES || L < 0 || N < 1 || sj_cap < 0 ||
      nblocks < 1 || sa_len < 1)
    return (int)cudaErrorInvalidValue;
  K2Args A{FmView{occ, nblocks, counts, c2, sa, sa_len, sentinel_row,
                  r1_row, cc_r0, cc_r1},
           tree, isa, codes, lens, k_read, job_x, job_mi, job_pos, job_d0,
           k_on, NK, L, N, l2ref, msl, ascent_cap,
           SeedRows{out_m, out_n, out_k, out_s, sj_cap}, count, overflow,
           work};
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  const int R = NK > 0 ? lanes_per_thread(NK, &blocks) : 1;
  if (R == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  fgdp_record(ev_start, s);
  int rc = 0;
  if (NK > 0) {
    if (R == 1)
      rc = launch<1>(A, max_rounds, slots, blk, s);
    else if (R == 4)
      rc = launch<4>(A, max_rounds, slots, blk, s);
    else
      rc = launch<16>(A, max_rounds, slots, blk, s);
  }
  fgdp_record(ev_end, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
