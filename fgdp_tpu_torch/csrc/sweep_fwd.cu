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
// Design: an ordinary launch, a 16-lane group (half a warp) a sweep
// lane, a grid-stride loop over the lanes; each group runs its lane's
// steps to the lane's own end (no barrier: the lanes are independent).
// The lane's state is the same in every lane of its group, so a group
// never diverges (the two groups of a warp may); every character select
// is a register select, so the kernel keeps no stack frame. An occ
// step's two rows are read by the group at once, one rank a lane, and
// gathered by shuffles (fm_forward_extend2_group, as K3); a walk step's
// SA entry is one address for the group, its five text words one a
// lane. The lane's read is staged once into the group's words of shared
// memory (2-bit codes and an N mask, K1's form and its coalesced loads
// and ballots; from the word of the lane's first anchor on, since a lane
// reads no position before it), so a walk step's
// 64-character read window is three shared-memory words and an occ
// step's two characters one; rows too long for eight groups' words in 48
// KB are read where they lie. The lead lane writes the pushes (four
// 4-byte stores: em/en/ek/es stay the separate rows flatten_entries
// takes). Eight groups a block (128 threads); the grid is as many blocks
// as the lanes need, at most what cudaOccupancyMaxActiveBlocksPerMultiprocessor
// lets be resident: K1's 4,096 lanes are 2,048 warps.
//
// What bounds it: the busiest lane's serial chain of steps, each the
// latency of a dependent gather of two 96-byte occ rows (a walk step:
// an SA entry, then five packed text words), plus the group's ranks and
// shuffles; the bytes over the whole batch are a few MB.
#include <cuda_runtime.h>

#include "sweep_fwd.cuh"

#define SWF_THREADS (SWEEP_GROUPS * FM_GROUP)

// The group policy on the card: the 16 lanes of a half warp, one rank of
// a step a lane; the group's first lane leads. (A warp a lane, its halves
// holding the same lane, measured 16-19% slower on K1's and K2's
// launches: twice the warps issue the same steps.)
struct SweepGroup : FmHalfWarp {
  __host__ __device__ void note(int) const {}
  // words w0 .. of the read's codes into the group's staged row, K1's
  // way: a word's 32 positions are two coalesced loads of the group, one
  // position a lane each, and six ballots (code bits and N, each half)
  // give every lane the word (lcp_stage_row_word's value)
  __host__ __device__ void stage(LcpWord* buf, const int* row, int L,
                                 int w0) const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);   // the group's last read of the buffer is done
    const int sh = threadIdx.x & 16;
    const auto bits = [&](int pred) {
      return (__ballot_sync(mask, pred) >> sh) & 0xFFFFu;
    };
    for (int w = w0; w < sweep_row_words(L); ++w) {
      const int p = 32 * w + g;
      int a, an, b, bn;
      lcp_stage_code(p < L ? fgdp_ld(row + p) : 0, a, an);
      lcp_stage_code(p + 16 < L ? fgdp_ld(row + p + 16) : 0, b, bn);
      const unsigned lo = bits(a & 1) | bits(b & 1) << 16;
      const unsigned hi = bits(a & 2) | bits(b & 2) << 16;
      const unsigned nb = bits(an) | bits(bn) << 16;
      if (g == (w & (FM_GROUP - 1)))
        buf[w] = LcpWord{lcp_spread(lo) | (lcp_spread(hi) << 1),
                         lcp_spread(nb)};
    }
    __syncwarp(mask);
#endif
  }
};

template <bool RESTART, bool WALK, bool STAGED>
__global__ void __launch_bounds__(SWF_THREADS)
    sweep_fwd_kernel(SweepFwdArgs A) {
  extern __shared__ LcpWord swf_rows[];
  const int gb = threadIdx.x / FM_GROUP;
  const SweepGroup grp{{(int)(threadIdx.x & (FM_GROUP - 1)),
                        0xFFFFu << (threadIdx.x & 16)}};
  LcpWord* buf = swf_rows + (long long)gb * sweep_row_words(A.L);
  for (int lane = blockIdx.x * SWEEP_GROUPS + gb; lane < A.NL;
       lane += gridDim.x * SWEEP_GROUPS)
    sweep_fwd_lane<RESTART, WALK, STAGED>(A, lane, grp, buf);
}

// the launch, with ev_start (or null) recorded right before it
template <bool RESTART, bool WALK, bool STAGED>
static void sweep_fwd_launch(const SweepFwdArgs& A, void* ev_start,
                             cudaStream_t s) {
  const auto kern = sweep_fwd_kernel<RESTART, WALK, STAGED>;
  const int smem = STAGED ? SWEEP_GROUPS * sweep_row_words(A.L) *
                                (int)sizeof(LcpWord)
                          : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SWF_THREADS,
                                                smem);
  const long long need = ((long long)A.NL + SWEEP_GROUPS - 1) / SWEEP_GROUPS;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  fgdp_record(ev_start, s);
  kern<<<(int)(need < most ? need : most), SWF_THREADS, smem, s>>>(A);
}

template <bool STAGED>
static void sweep_fwd_dispatch(const SweepFwdArgs& A, bool restart,
                               bool walk, void* ev, cudaStream_t s) {
  if (restart && walk)
    sweep_fwd_launch<true, true, STAGED>(A, ev, s);
  else if (restart)
    sweep_fwd_launch<true, false, STAGED>(A, ev, s);
  else if (walk)
    sweep_fwd_launch<false, true, STAGED>(A, ev, s);
  else
    sweep_fwd_launch<false, false, STAGED>(A, ev, s);
}

// 1 where a launch at row length L stages the codes, else 0
extern "C" int fgdp_sweep_fwd_staged(int L) { return sweep_staged(L); }

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
  if (NL == 0) {
    fgdp_record(ev_start, s);
  } else if (sweep_staged(L)) {
    sweep_fwd_dispatch<true>(A, restart, walk, ev_start, s);
  } else {
    sweep_fwd_dispatch<false>(A, restart, walk, ev_start, s);
  }
  fgdp_record(ev_end, s);
  return (int)cudaGetLastError();
}
