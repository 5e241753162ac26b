// The wave machine that the LCP engine's K1 (smem_lcp.cuh) and K2
// (k2_lcp.cuh) kernels share: the lanes' mode counts over the whole
// machine, the EXT/WALK/SHR wave alternation with its exit tests, and
// the seed-buffer append. Built into the cooperative kernels with a grid
// policy (GridBar below: a block reduction of the counts and one
// hand-written grid barrier a step, the counts riding on its arrival)
// and into the host twin with a serial one (every lane in one thread, the
// counts taken step by step).
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

// The machine's lanes in each live mode (kept lanes only).
struct ModeCounts {
  int ext, walk, shr;
};

FGDP_HD int seed_live(const ModeCounts& t) { return t.ext + t.shr + t.walk; }

// t's count of mode m (m a live mode)
FGDP_HD int seed_of(const ModeCounts& t, int m) {
  return m == SEED_EXT ? t.ext : (m == SEED_WALK ? t.walk : t.shr);
}

// the wave split's buckets (K1's work counters [4, 16)): a step of the
// EXT, WALK or SHR wave, the cascade's levels 1 and 2 (the compaction
// scan and the level's first count), and the launch's start (set-up and
// the first count)
#define SEED_BUCKETS 6
#define SEED_B_CASCADE 3
#define SEED_B_START 5

FGDP_HD int seed_bucket(int m) {
  return m == SEED_EXT ? 0 : (m == SEED_WALK ? 1 : 2);
}

// a thread's own counts (registers: no array indexed by a mode)
template <class Lanes>
FGDP_HD ModeCounts seed_local_counts(const Lanes& ln) {
  ModeCounts c{0, 0, 0};
  for (int i = 0; i < (int)ln.size(); ++i) {
    const bool k = ln[i].kept;
    c.ext += (k && ln[i].mode == SEED_EXT) ? 1 : 0;
    c.walk += (k && ln[i].mode == SEED_WALK) ? 1 : 0;
    c.shr += (k && ln[i].mode == SEED_SHR) ? 1 : 0;
  }
  return c;
}

// The steps of wave M while its lanes number more than an eighth of the
// live ones; `tot` holds the counts before the first and ends with
// those after the last. M is a constant, so each wave's step is inlined
// alone.
template <int M, class Grid, class Lanes, class Step>
FGDP_HD void seed_wave(Grid& g, Lanes& ln, ModeCounts& tot, Step& step) {
  while (seed_of(tot, M) > (seed_live(tot) >> 3)) {
    // one copy of the step: unrolled over 16 lanes it took 255 registers
#pragma unroll 1
    for (int i = 0; i < (int)ln.size(); ++i)
      if (ln[i].kept && ln[i].mode == M) step(ln[i], M);
    tot = g.counts(seed_local_counts(ln), seed_bucket(M));
  }
}

// One bounded run of the wave alternation: the modes Waves in their
// order in a round; step(lane, mode) advances one lane one step. The
// phase's first count goes to `bucket`.
template <int... Waves, class Grid, class Lanes, class Step>
FGDP_HD void seed_wave_phase(Grid& g, Lanes& ln, int round_cap, Step& step,
                             int bucket) {
  ModeCounts tot = g.counts(seed_local_counts(ln), bucket);
  int rnd = 0;
  while (rnd < round_cap && seed_live(tot) > 0) {
    ++rnd;
    (seed_wave<Waves>(g, ln, tot, step), ...);
  }
}

// the most lanes a machine may have: the grid packs each mode's count
// into 21 bits
#define SEED_MAX_LANES ((1 << 21) - 1)
// below this many lanes (and 8,192 blocks) one 64-bit word holds a
// step's three counts (17 bits each) and its arrivals (13 bits)
#define SEED_NARROW_LANES (1 << 17)

#ifdef __CUDACC__
// The grid barrier of the cooperative launches (K1, K2; the chase probe
// times it alone), written by hand for one 64-bit word a step. A step
// counts each block's lanes by mode (a warp reduction of three 10-bit
// fields, then thread 0 over the warps' sums in shared memory), and
// thread 0 adds the block's counts and its arrival into the step's slot
// with one atom.add.acq_rel.gpu, then spins with ld.acquire.gpu until
// the slot shows every block's arrival; the word it reads last holds the
// totals, which every thread takes from shared memory after one
// __syncthreads. Narrow (fewer than 2^17 lanes): the counts 17 bits each
// at bits 0, 17, 34 and the arrivals at bit 51 of one word. Wide (up to
// 2^21 - 1 lanes): the counts 21 bits each in the slot's first word by
// one red.add, the arrivals in its second word, and the totals read once
// the arrivals are in. The narrow form is the faster: K1 on the scale
// index's batch of 4,096 reads took 0.7985 and 0.8017 ms with it, 0.8553
// and 0.8558 with the wide form forced (H100 80GB HBM3 at 700 W,
// chip_smoke.py --phases scale, in turns), about 0.15 us more a grid
// step, likely the red.add's round trip ahead of the arrival's release.
// Barrier u uses slot u % 3, and block 0 zeroes slot (u + 1) % 3 before
// it arrives at u: that slot's last reads (barrier u - 2) ended before
// every block arrived at u - 1, and its next adds (barrier u + 1) start
// after every block saw barrier u, block 0's release included. The
// slots start zeroed (torch.zeros). With `wave`
// set, thread 0 of block 0 reads %globaltimer after each barrier and adds
// the time since the last one, and one step, to the bucket the caller
// names (K1's wave split), kept in shared memory until finish().
__device__ __forceinline__ unsigned long long bar_atom_add(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.add.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void bar_red_add(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("red.relaxed.gpu.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long bar_ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long bar_ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void bar_st_relaxed(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ long long bar_clock_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct GridBar {
  unsigned long long* slots;   // [3][2], zeroed
  int* blk;                    // [gridDim.x], the scan's block totals
  long long* wave;             // [2 * SEED_BUCKETS] ns, then steps; or null
  bool narrow;
  int nbar = 0;    // barriers passed: the same in every thread
  int step = 0;    // counts taken: the same in every thread
  long long t_last = 0;

  __device__ long long* wave_acc() {
    __shared__ long long acc[2 * SEED_BUCKETS];
    return acc;
  }

  // thread 0 of block 0, when the wave split is asked for
  __device__ bool timer() const {
    return wave != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  }

  __device__ void start() {
    if (timer()) {
      long long* acc = wave_acc();
      for (int i = 0; i < 2 * SEED_BUCKETS; ++i) acc[i] = 0;
      t_last = bar_clock_ns();
    }
  }

  __device__ void finish() {
    if (timer()) {
      const long long* acc = wave_acc();
      for (int i = 0; i < 2 * SEED_BUCKETS; ++i) wave[i] = acc[i];
    }
  }

  // thread 0: arrive at barrier nbar with the block's packed counts;
  // returns the slot's word of totals once every block has arrived
  __device__ unsigned long long arrive(unsigned long long add) {
    unsigned long long* cur = slots + 2 * (nbar % 3);
    if (blockIdx.x == 0) {
      unsigned long long* nxt = slots + 2 * ((nbar + 1) % 3);
      bar_st_relaxed(nxt, 0);
      bar_st_relaxed(nxt + 1, 0);
    }
    const unsigned long long n = gridDim.x;
    if (narrow) {
      const unsigned long long a = add + (1ull << 51);
      unsigned long long v = bar_atom_add(cur, a) + a;
      while ((v >> 51) != n) v = bar_ld_acquire(cur);
      return v;
    }
    if (add) bar_red_add(cur, add);
    unsigned long long v = bar_atom_add(cur + 1, 1) + 1;
    while (v != n) v = bar_ld_acquire(cur + 1);
    return bar_ld_relaxed(cur);
  }

  // the time since the last barrier to `bucket`, and one grid step
  // when the barrier took counts
  __device__ void mark(int bucket, bool counted) {
    if (timer()) {
      const long long t = bar_clock_ns();
      if (bucket >= 0) {
        long long* acc = wave_acc();
        acc[bucket] += t - t_last;
        acc[SEED_BUCKETS + bucket] += counted ? 1 : 0;
      }
      t_last = t;
    }
  }

  // the machine's counts from every thread's own; the barrier's time
  // goes to `bucket` (-1: none)
  __device__ ModeCounts counts(const ModeCounts& loc, int bucket) {
    __shared__ unsigned ws[32];
    __shared__ int tot[3];
    const unsigned mine = (unsigned)loc.ext | ((unsigned)loc.walk << 10) |
                          ((unsigned)loc.shr << 20);
    const unsigned w = __reduce_add_sync(0xffffffffu, mine);
    if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = w;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long e = 0, k = 0, s = 0;
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
        e += ws[i] & 1023u;
        k += (ws[i] >> 10) & 1023u;
        s += ws[i] >> 20;
      }
      const int b = narrow ? 17 : 21;
      const unsigned long long v = arrive(e | (k << b) | (s << (2 * b)));
      const unsigned long long m = (1ull << b) - 1;
      tot[0] = (int)(v & m);
      tot[1] = (int)((v >> b) & m);
      tot[2] = (int)((v >> (2 * b)) & m);
      mark(bucket, true);
    }
    __syncthreads();
    ++nbar;
    ++step;
    return ModeCounts{tot[0], tot[1], tot[2]};
  }

  // the barrier alone (the chase probe's GridBar modes), with a count
  // of one a block, so that the wide form pays for its red.add as a
  // step's counts do
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) arrive(1);
    __syncthreads();
    ++nbar;
  }

  // the sum of v over the threads before this one (block-major order);
  // the barrier's time goes to `bucket`
  __device__ int exscan(int v, int bucket) {
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
    if (threadIdx.x == 0) {
      // published by the arrival's release
      __stcg(blk + blockIdx.x, ws[nw - 1]);
      arrive(0);
      mark(bucket, false);
    }
    __syncthreads();
    ++nbar;
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
