// The wave machine that the LCP engine's K1 (smem_lcp.cuh) and K2
// (k2_lcp.cuh) kernels share: the lanes' mode counts over the whole
// machine, the EXT/WALK/SHR wave alternation with its exit tests, and
// the seed-buffer append. Built into the cooperative kernels with a grid
// policy (CoopGrid below: block reductions, atomics into global counters
// and one grid barrier a step) and into the host twin with a serial one
// (every lane in one thread, the counts taken step by step).
//
// The exit tests are those of the JAX package's lax.while_loops (and the
// port's torch-op loops): a round runs each wave in turn, and a wave
// steps while the lanes in its mode number more than one eighth of the
// live lanes (live >> 3), the counts taken over the machine's lanes
// before every step; rounds stop at the round cap or when no lane is
// live. A step moves only the lanes in the wave's mode, so a lane's own
// logic is the same whichever thread runs it; the counts decide how
// many steps each wave takes, which decides the overflow flags, so every
// thread reads the same totals and takes the same branch.
#pragma once

#include "common.cuh"

#define SEED_EXT 0    // backward-extending
#define SEED_SHR 1    // ascending the LCP tree
#define SEED_DEAD 2
#define SEED_WALK 3   // single-suffix text walk (K1 only)
#define SEED_INT32_MAX 2147483647

// codes[rid, j] with j outside [0, L) -> 4 (_read_base_at)
FGDP_HD int seed_read_at(const int* codes, int L, int rid, int j) {
  return (j >= 0 && j < L) ? fgdp_ld(codes + (long long)rid * L + j) : 4;
}

// (lcp, left, right, mask) row of the LCP tree, index clamped to [0, N]
FGDP_HD void seed_tree_row(const int* tree, int N, int idx, int e[4]) {
  fgdp_ld4(tree + 4LL * fgdp_min(fgdp_max(idx, 0), N), e);
}

// the parent of node [lo, hi): the row of the deeper endpoint
FGDP_HD void seed_tree_parent(const int* tree, int N, int lo, int hi,
                              int e[4]) {
  int tl[4], th[4];
  seed_tree_row(tree, N, lo, tl);
  seed_tree_row(tree, N, hi, th);
  const bool pick_lo = tl[0] >= th[0];
  for (int t = 0; t < 4; ++t) e[t] = pick_lo ? tl[t] : th[t];
}

// One lane's seed rows (SeedBatch or LaneSeeds): a value lands at slot
// `cnt` below the capacity S; a full row flags overflow and drops it
// (_append_seed).
struct SeedRows {
  int* m;
  int* n;
  int* k;
  int* s;
  int S;
};

FGDP_HD void seed_append(const SeedRows& o, long long row, int& cnt,
                         bool& ovf, int m, int n, int k, int s) {
  if (cnt < o.S) {
    const long long at = row * o.S + cnt;
    o.m[at] = m;
    o.n[at] = n;
    o.k[at] = k;
    o.s[at] = s;
    ++cnt;
  } else {
    ovf = true;
  }
}

// The work counters a launch may be asked for (int64[4], null when not):
// [0] bytes of table rows and entries gathered (occ rows, tree rows, SA
// and ISA entries, packed text words), [1] the machine's grid steps
// (counts taken; for K3, which has none, the most extension steps, each
// a gather of two occ rows, of any read), [2] lane steps, [3] the
// longest lane's own steps (before the waves, for K2; a read's, for K3).
FGDP_HD void seed_work_add(long long* w, long long v) {
#ifdef __CUDA_ARCH__
  if (v) atomicAdd(reinterpret_cast<unsigned long long*>(w),
                   (unsigned long long)v);
#else
  *w += v;
#endif
}

FGDP_HD void seed_work_max(long long* w, long long v) {
#ifdef __CUDA_ARCH__
  atomicMax(w, v);
#else
  if (v > *w) *w = v;
#endif
}

// A thread's lanes on the card: R lanes, lane i of thread t is lane
// t R + i of the machine (a thread's lanes are consecutive, so a scan
// over the threads orders the lanes).
template <class Lane, int R>
struct LaneArray {
  Lane v[R];
  FGDP_HD static constexpr int size() { return R; }
  FGDP_HD Lane& operator[](int i) { return v[i]; }
  FGDP_HD const Lane& operator[](int i) const { return v[i]; }
};

FGDP_HD int seed_live(const int tot[4]) {
  return tot[SEED_EXT] + tot[SEED_SHR] + tot[SEED_WALK];
}

// lanes of the machine in each mode (kept lanes only), over every thread
template <class Grid, class Lanes>
FGDP_HD void seed_counts(Grid& g, const Lanes& ln, int tot[4]) {
  int loc[4] = {0, 0, 0, 0};
  for (int i = 0; i < (int)ln.size(); ++i)
    if (ln[i].kept) ++loc[ln[i].mode];
  g.sum4(loc, tot);
}

// One bounded run of the wave alternation: `waves` lists the modes in
// their order in a round; step(lane, mode) advances one lane one step.
template <class Grid, class Lanes, class Step>
FGDP_HD void seed_wave_phase(Grid& g, Lanes& ln, int round_cap,
                             const int* waves, int nwaves, Step& step) {
  int tot[4];
  seed_counts(g, ln, tot);
  int rnd = 0;
  while (rnd < round_cap && seed_live(tot) > 0) {
    ++rnd;
    for (int w = 0; w < nwaves; ++w) {
      const int m = waves[w];
      while (tot[m] > (seed_live(tot) >> 3)) {
        for (int i = 0; i < (int)ln.size(); ++i)
          if (ln[i].kept && ln[i].mode == m) step(ln[i], m);
        seed_counts(g, ln, tot);
      }
    }
  }
}

#ifdef __CUDACC__
#include <cooperative_groups.h>

// The grid policy of a cooperative launch. Counts: a warp reduction, a
// block sum in shared memory, one atomicAdd a block into one of three
// counter sets in global memory, one grid barrier, and every thread
// reads the totals. Step u adds into set u % 3 and block 0 zeroes set
// (u + 1) % 3, whose last reads (step u - 2) ended before barrier u - 1
// and whose next adds (step u + 1) start after barrier u: one barrier a
// step. The counter sets start zeroed (the wrapper allocates them with
// torch.zeros).
struct CoopGrid {
  int* sets;    // int32[3][4]
  int* blk;     // int32[gridDim.x], the scan's block totals
  int step;     // counts taken so far: the same in every thread

  __device__ void sum4(const int loc[4], int tot[4]) {
    __shared__ int sh[4];
    if (threadIdx.x < 4) sh[threadIdx.x] = 0;
    __syncthreads();
    for (int t = 0; t < 4; ++t) {
      const int v = __reduce_add_sync(0xffffffffu, loc[t]);
      if ((threadIdx.x & 31) == 0 && v) atomicAdd(&sh[t], v);
    }
    __syncthreads();
    int* cur = sets + (step % 3) * 4;
    if (threadIdx.x < 4 && sh[threadIdx.x])
      atomicAdd(cur + threadIdx.x, sh[threadIdx.x]);
    if (blockIdx.x == 0 && threadIdx.x < 4)
      atomicExch(sets + ((step + 1) % 3) * 4 + threadIdx.x, 0);
    cooperative_groups::this_grid().sync();
    for (int t = 0; t < 4; ++t) tot[t] = __ldcg(cur + t);
    ++step;
  }

  // the sum of v over the threads before this one (block-major order)
  __device__ int exscan(int v) {
    __shared__ int ws[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = (blockDim.x + 31) >> 5;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = lane < nw ? ws[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      ws[lane] = t;
    }
    __syncthreads();
    const int in_block = (warp ? ws[warp - 1] : 0) + x - v;
    if (threadIdx.x == 0) atomicExch(blk + blockIdx.x, ws[nw - 1]);
    __syncthreads();
    cooperative_groups::this_grid().sync();
    // the blocks before this one, summed by the block's threads
    int part = 0;
    for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x)
      part += __ldcg(blk + b);
    part = __reduce_add_sync(0xffffffffu, part);
    if (lane == 0) ws[warp] = part;
    __syncthreads();
    int base = 0;
    for (int w = 0; w < nw; ++w) base += ws[w];
    __syncthreads();
    return base + in_block;
  }
};

// Launch `kernel` cooperatively with the fewest blocks of `threads` that
// hold `lanes` lanes at `R` a thread, if they can all be resident.
// Returns 0 and sets *blocks, or cudaErrorCooperativeLaunchTooLarge.
template <class K>
static int coop_blocks(K kernel, int threads, int lanes, int R,
                       int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const long long need = ((long long)lanes + (long long)R * threads - 1) /
                         ((long long)R * threads);
  *blocks = (int)(need > 0 ? need : 1);
  return (long long)*blocks <= (long long)per_sm * sms
             ? 0
             : (int)cudaErrorCooperativeLaunchTooLarge;
}
#endif
