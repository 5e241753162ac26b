// K1 of the LCP seeding engine for Hopper (sm_90a): every read's SMEMs
// by one pass of backward extension and LCP-tree ascent.
//
// Replaces the JAX package's device loop fgdp_tpu/ops/smem_lcp.py:50
// smem_all_lcp (D2: the lax.while_loops of its EXT, WALK and SHR waves,
// :254-279, and the straggler cascade around them), which the port ran
// as a Python loop of torch ops with a host sync at every loop test. The
// logic per lane is smem_lcp.cuh, the wave machine and its grid barrier
// seed_waves.cuh, the rank primitives fm.cuh (D1).
//
// Design: one cooperative launch for the whole machine, one thread a
// read (R = 1 while the reads fit in the resident threads, else 4 or 16
// lanes a thread, lanes t R .. t R + R - 1), the lanes' state in
// registers; every grid step is one wave's step of its lanes, then the
// machine's mode counts, which every thread reads alike, so every thread
// takes the same exit. The cascade's stable compaction is an exclusive
// scan of the threads' live counts across the grid. A launch that cannot
// be resident returns cudaErrorCooperativeLaunchTooLarge and the wrapper
// raises.
//
// What bounds it: the serial chain of grid steps (370 on the scale
// index's primary batch of 4,096 reads), each a grid barrier and the
// slowest lane's dependent gathers. The design-independent bound
// (probes.chase on that index, H100 80GB HBM3 at 700 W) is a dependent
// gather of two occ rows, 0.75 us, plus a barrier, 1.15 us for
// cooperative_groups' grid sync at 64 x 64: 0.71 ms against the first
// design's 1.58 (4.27 us a grid step). The bytes over a batch are a few
// MB, microseconds at the card's memory rate. Against each part of the
// first design's step:
//
// 1. EXT took two dependent global rounds a step: the read's two codes,
//    then the two occ rows at addresses that depend on them. Each warp
//    now stages its 32 R reads into shared memory at the start, 32
//    positions at a time (a coalesced load a read, then three ballots:
//    the 2-bit codes and an N mask, 16 bytes per 32 positions, 80 bytes
//    a 151 bp read), and C and C2 (20 ints) sit in shared memory too, so
//    an EXT step's only global round is the two rows (each row's packed
//    words and its two counts, loads issued together). Rows that do not
//    fit in 48 KB of shared memory a block (64 threads x R x ceil(L /
//    32) x 16 bytes; L up to 1,536 at R = 1) are read where they lie,
//    as K3 does past L 6,144.
// 2. A WALK step was a 64-iteration loop of a read code and a text word,
//    each a global load behind a break (up to 128 loads in a chain). It
//    is now one packed compare: the five text words that cover pos - 64
//    .. pos - 1 (their addresses depend on pos alone, loaded together),
//    the read's window of l - 64 .. l - 1 from its staged words (three
//    16-byte shared loads), an XOR of the 2-bit codes, the N mask and
//    the range masks ORed in, and the first bad position by __clzll. A
//    WALK step is at most three rounds (SA at a walk's first step, the
//    text words, ISA after a mismatch).
// 3. The counts cost two __syncthreads, shared and global atomics, an
//    atomicExch, cooperative_groups' grid sync (its own __syncthreads,
//    fence, atomic and spin) and four loads after it. Now (GridBar): a
//    warp reduction of the three counts packed into one word, one
//    __syncthreads, thread 0 adds the block's counts and its arrival
//    into the step's slot by one 64-bit atom.add.acq_rel.gpu and spins
//    with ld.acquire.gpu on that word, whose last value holds the totals
//    (no read after the barrier), and one __syncthreads: 0.92 us at 64 x
//    64 against cooperative_groups' 1.14. 64 threads a block, measured
//    once on the batch: 0.7947 ms, against 0.7964 at 32, 0.7999 at 128
//    and 0.8240 at 256 (fewer blocks arrive, but fewer SMs hold the
//    lanes' loads).
// 4. No local array is indexed at run time (the counts are three
//    registers, the waves' modes constants of a template alternation;
//    the first design's R = 1 kernel kept 64 bytes of stack for them), so
//    the R = 1 kernels keep no stack frame; chip_smoke.py's build phase
//    reads it from the built library.
//
// Measured (chip_smoke.py's scale phase, H100 80GB HBM3 at 700 W): 0.79
// ms on the batch, 2.15 us a grid step, 1.31x the bound of 0.61 ms that
// the probe gives with GridBar (370 x (0.73 + 0.92 us)). The outputs,
// the steps and the work counters are the first design's exactly: the
// same lanes step in the same order.
#include <cuda_runtime.h>

#include "smem_lcp.cuh"

#define LCP_THREADS 64        // threads a block
#define LCP_STAGE_BYTES (48 * 1024)

// A warp stages its 32 R reads (rows wbase .. wbase + 32 R - 1 of the
// block, read first + row), word by word: lane j loads position 32 w + j
// of each of 32 reads (32 coalesced loads in flight), three ballots make
// a read's word, and lane k keeps read k's (lcp_stage_word's value).
template <int R>
__device__ void lcp_stage(const LcpArgs& A, LcpWord* rows, int nw,
                          int first) {
  const int lane = threadIdx.x & 31;
  const int wbase = (threadIdx.x & ~31) * R;
  for (int q = 0; q < R; ++q) {
    const int row0 = wbase + 32 * q;
    for (int w = 0; w < nw; ++w) {
      const int p = 32 * w + lane;
      int c[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int id = first + row0 + k;
        c[k] = (id < A.B && p < A.L)
                   ? fgdp_ld(A.codes + (long long)id * A.L + p)
                   : 0;
      }
      unsigned lo = 0, hi = 0, nb = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        int code, n;
        lcp_stage_code(c[k], code, n);
        const unsigned b0 = __ballot_sync(0xffffffffu, code & 1);
        const unsigned b1 = __ballot_sync(0xffffffffu, code & 2);
        const unsigned bn = __ballot_sync(0xffffffffu, n);
        if (lane == k) {
          lo = b0;
          hi = b1;
          nb = bn;
        }
      }
      rows[(long long)(row0 + lane) * nw + w] =
          LcpWord{lcp_spread(lo) | (lcp_spread(hi) << 1), lcp_spread(nb)};
    }
  }
  __syncwarp();
}

// four and sixteen lanes a thread: at most 128 registers (8 blocks of
// 64 threads an SM: 2,048 and 8,192 lanes), so that four lanes a thread
// hold more lanes than one does (1,024 an SM at 64 registers) with the
// rows staged or in place, and sixteen hold as many as the first
// design's (121 registers)
template <int R, bool STAGED>
__global__ void __launch_bounds__(LCP_THREADS, R == 1 ? 1 : 8)
    smem_lcp_kernel(LcpArgs A, int max_rounds, unsigned long long* slots,
                    int* blk, int narrow) {
  extern __shared__ LcpWord lcp_rows[];
  __shared__ int kc[20];
  GridBar g{slots, blk, A.work != nullptr ? A.work + 4 : nullptr,
            narrow != 0};
  g.start();
  if (threadIdx.x < 20)
    kc[threadIdx.x] = fgdp_ld(threadIdx.x < 4
                                  ? A.fm.counts + threadIdx.x
                                  : A.fm.c2 + (threadIdx.x - 4));
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int first = blockIdx.x * blockDim.x * R;
  const int nw = (A.L + 31) >> 5;
  if constexpr (STAGED) lcp_stage<R>(A, lcp_rows, nw, first);
  __syncthreads();
  LaneArray<LcpLane, R> ln;
#pragma unroll
  for (int i = 0; i < R; ++i) lcp_lane_init(A, ln[i], t * R + i);
  if constexpr (STAGED) {
    const LcpStaged rows{lcp_rows, nw, first, kc};
    lcp_machine(A, g, ln, max_rounds, LcpStep<LcpStaged>{A, rows});
  } else {
    const LcpInPlace rows{kc};
    lcp_machine(A, g, ln, max_rounds, LcpStep<LcpInPlace>{A, rows});
  }
#pragma unroll
  for (int i = 0; i < R; ++i) lcp_lane_finish(A, ln[i]);
  g.finish();
  if (A.work != nullptr && t == 0) A.work[1] = g.step;
}

// A launch's shape: blocks of LCP_THREADS, R lanes a thread, the rows
// staged or read in place, and the blocks an SM holds of that kernel.
struct LcpPlan {
  int blocks, R, staged, per_sm;
};

static const void* lcp_kernel(int R, int staged) {
  if (R == 1)
    return staged ? (const void*)smem_lcp_kernel<1, true>
                  : (const void*)smem_lcp_kernel<1, false>;
  if (R == 4)
    return staged ? (const void*)smem_lcp_kernel<4, true>
                  : (const void*)smem_lcp_kernel<4, false>;
  return staged ? (const void*)smem_lcp_kernel<16, true>
                : (const void*)smem_lcp_kernel<16, false>;
}

static long long lcp_stage_bytes(const LcpPlan& p, int L) {
  return p.staged ? (long long)LCP_THREADS * p.R * ((L + 31) / 32) *
                        (long long)sizeof(LcpWord)
                  : 0;
}

// The fewest lanes a thread (1, 4, 16) whose blocks can all be
// resident, the rows staged where their shared memory fits. Returns 0,
// cudaErrorCooperativeLaunchTooLarge, or cudaErrorInvalidValue for a bad
// length.
static int lcp_plan(int B, int L, LcpPlan* p) {
  if (L < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int Rs[3] = {1, 4, 16};
  for (int ri = 0; ri < 3; ++ri) {
    for (int staged = 1; staged >= 0; --staged) {
      LcpPlan c{1, Rs[ri], staged, 0};
      const long long smem = lcp_stage_bytes(c, L);
      if (smem > LCP_STAGE_BYTES) continue;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c.per_sm, lcp_kernel(c.R, staged), LCP_THREADS, (size_t)smem);
      const long long lanes = (long long)c.R * LCP_THREADS;
      const long long need = B > 0 ? ((long long)B + lanes - 1) / lanes : 1;
      c.blocks = (int)need;
      if (need <= (long long)c.per_sm * sms) {
        *p = c;
        return 0;
      }
    }
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

// The launch of B reads of L codes: plan[0..4] = blocks, threads a
// block, lanes a thread, staged (1) or in place (0), resident blocks an
// SM of that kernel. Returns 0 or the error fgdp_smem_lcp would return.
extern "C" int fgdp_smem_lcp_plan(int B, int L, int* plan) {
  LcpPlan p{};
  const int rc = lcp_plan(B, L, &p);
  plan[0] = p.blocks;
  plan[1] = LCP_THREADS;
  plan[2] = p.R;
  plan[3] = p.staged;
  plan[4] = p.per_sm;
  return rc;
}

// the most blocks a launch of B reads uses (the size of `blk`)
extern "C" int fgdp_smem_lcp_max_blocks(int B) {
  return (B + LCP_THREADS - 1) / LCP_THREADS + 1;
}

// occ int32[nblocks, 24], counts int32[5], c2 int32[17], sa int32[sa_len]
// (the DeviceFMIndex); tree int32[N + 1, 4], isa int32[N]; codes
// int32[B, L], lens int32[B], active bool[B]; words int64[nwords] (the
// reference's packed words, DeviceReference.codes16); out_m/n/k/s
// int32[B, S] zeroed, count int32[B], overflow bool[B]; slots int64[6]
// zeroed, blk int32[fgdp_smem_lcp_max_blocks(B)]; work int64[4 + 2
// SEED_BUCKETS] zeroed (seed_waves.cuh's counters, then the wave split:
// ns and grid steps of each bucket) or null. ev_start/ev_end are
// cudaEvent_t or null, recorded on `stream` just before and just after
// the launch. Returns cudaGetLastError() after the launch, the launch's
// own error (cudaErrorCooperativeLaunchTooLarge when the lanes cannot all
// be resident), or cudaErrorInvalidValue for a bad shape (B above
// SEED_MAX_LANES among them).
extern "C" int fgdp_smem_lcp(
    const int* occ, long long nblocks, const int* counts, const int* c2,
    const int* sa, long long sa_len, int sentinel_row, int r1_row,
    int cc_r0, int cc_r1, const int* tree, const int* isa, const int* codes,
    const int* lens, const unsigned char* active, const long long* words,
    long long nwords, int B, int L, int N, int l2ref, int msl, int S,
    int max_rounds, int* out_m, int* out_n, int* out_k, int* out_s,
    int* count, unsigned char* overflow,
    unsigned long long* slots, int* blk, long long* work, void* ev_start,
    void* ev_end, void* stream) {
  if (B < 0 || B > SEED_MAX_LANES || L < 0 || N < 1 || S < 0 ||
      nblocks < 1 || sa_len < 1 || nwords < 1)
    return (int)cudaErrorInvalidValue;
  LcpArgs A{FmView{occ, nblocks, counts, c2, sa, sa_len, sentinel_row,
                   r1_row, cc_r0, cc_r1},
            tree, isa, codes, lens, active, words, nwords, B, L, N, l2ref,
            msl, SeedRows{out_m, out_n, out_k, out_s, S}, count, overflow,
            work};
  cudaStream_t s = (cudaStream_t)stream;
  LcpPlan p{};
  const int prc = lcp_plan(B, L, &p);
  if (prc) return prc;
  int narrow = (B < SEED_NARROW_LANES && p.blocks < (1 << 13)) ? 1 : 0;
  const long long smem = lcp_stage_bytes(p, L);
  fgdp_record(ev_start, s);
  int rc = 0;
  if (B > 0) {
    void* args[] = {&A, &max_rounds, &slots, &blk, &narrow};
    rc = (int)cudaLaunchCooperativeKernel(lcp_kernel(p.R, p.staged),
                                          p.blocks, LCP_THREADS, args,
                                          (size_t)smem, s);
  }
  fgdp_record(ev_end, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
