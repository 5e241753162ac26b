// Seed-chaining loop kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fgdp_tpu/ops/chain_pallas.py (_kernel, launched
// by chain_loop_pallas): per read, seeds are inserted in slot order into
// a C-slot chain table (contained -> dropped, growable -> appended, else
// a new chain), with the wq/wr weights, each seed's chain id and the
// overflow flag when all C slots are used.
//
// Design: one warp per read (chain_loop.cuh, chain_read_regs). pos, the
// key of the search, lives in registers: slot c in lane c % 32, register
// c / 32, K = ceil(C / 32) a template parameter (every K up to CH_MAX_K
// is instantiated: C <= 256, the widest the escalation ladder makes).
// The other fields live in the warp's table in shared memory (12 KB at
// C = 256), read with broadcast 16-byte loads: with them in registers
// too, a step's writes and reads took 12 K selects and 11 shuffles, and
// C = 256 ran 0.96 ms against 0.59 here on an H100 (PERF.md). Seeds come
// in 32 slots at a time with coalesced loads, the next chunk in flight;
// invalid slots are skipped by walking the chunk's ballot word. "Largest
// pos <= rbeg, ties to the latest slot" is two warp max-reductions, run
// for step t + 1 beside step t's decision and corrected by step t's new
// chain with one compare (a chain's pos never changes after it opens).
// Launches whose C is above 32 CH_MAX_K take the wide path, the whole
// table in shared memory (chain_read_wide); the C entry point chooses
// from C before the launch and reports the path.
//
// What bounds it: the chain of dependent steps inside the longest read.
// The bytes (the valid flags, 4 words per valid slot, the table and the
// chain ids) and the issue of the batch's steps take microseconds; a
// read's steps are serial, so the kernel takes at least the longest
// read's valid steps times one step's latency. That latency is what the
// design cuts: the search, the seed shuffles and the row loads run
// beside the decision's own integer chain; what is left is about 175
// warp instructions a step, issued in order.
#include <cuda_runtime.h>

#include "chain_loop.cuh"

constexpr int kWarps = 2;   // reads per block

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    chain_regs_kernel(ChainArgs a) {
  extern __shared__ __align__(16) int tables[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.B) return;   // uniform per warp
  WarpLanes L;
  chain_read_regs<K>(a, b, tables + warp * CH_NFIELDS * a.C, L);
}

__global__ void chain_wide_kernel(ChainArgs a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.B) return;   // uniform per warp
  WarpLanes L;
  chain_read_wide(a, b, smem + warp * CH_NFIELDS * a.C, L);
}

static void launch_regs(int K, const ChainArgs& a, cudaStream_t s) {
  static_assert(CH_MAX_K == 8, "instantiate every K up to CH_MAX_K");
  const int blocks = (a.B + kWarps - 1) / kWarps;
  // 12 KB a warp at C = 256
  const size_t shmem = (size_t)kWarps * CH_NFIELDS * a.C * sizeof(int);
#define CH_LAUNCH(k)                                              \
  case k:                                                         \
    chain_regs_kernel<k><<<blocks, kWarps * 32, shmem, s>>>(a);   \
    break;
  switch (K) {
    CH_LAUNCH(1) CH_LAUNCH(2) CH_LAUNCH(3) CH_LAUNCH(4)
    CH_LAUNCH(5) CH_LAUNCH(6) CH_LAUNCH(7) CH_LAUNCH(8)
  }
#undef CH_LAUNCH
}

// the widest C the register path takes
extern "C" int fgdp_chain_reg_max_c() { return 32 * CH_MAX_K; }

// qbeg/rbeg/slen/rid int32[B, P], valid bool[B, P], ovf_in bool[B] ->
// out int32[10, B, C] (pos, crid, fq, fr, lq, lr, ll, ns, wq, wr),
// n_out int32[B], ovf_out bool[B], chain_of int32[B, P]. *path (host
// memory) receives the path taken: 0 the register path
// (C <= fgdp_chain_reg_max_c()), 1 the wide one. ev_start/ev_end are
// cudaEvent_t or null, recorded on `stream` just before and just after
// the launch (no host time falls between them). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int fgdp_chain_loop(const int* qbeg, const int* rbeg,
                               const int* slen, const int* rid,
                               const unsigned char* valid,
                               const unsigned char* ovf_in, int B, int P,
                               int C, int l_pac, int w, int max_chain_gap,
                               int* out, int* n_out, unsigned char* ovf_out,
                               int* chain_of, int* path, void* ev_start,
                               void* ev_end, void* stream) {
  if (C < 1 || P < 0) return (int)cudaErrorInvalidValue;
  ChainArgs a{qbeg, rbeg, slen, rid, valid, ovf_in, B, P, C, l_pac, w,
              max_chain_gap, out, n_out, ovf_out, chain_of};
  cudaStream_t s = (cudaStream_t)stream;
  const int K = (C + 31) / 32;
  if (K <= CH_MAX_K) {
    *path = 0;
    fgdp_record(ev_start, s);
    if (B > 0) launch_regs(K, a, s);
    fgdp_record(ev_end, s);
    return (int)cudaGetLastError();
  }
  const size_t shmem = (size_t)kWarps * CH_NFIELDS * C * sizeof(int);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  *path = 1;
  fgdp_record(ev_start, s);
  if (B > 0) {
    const int blocks = (B + kWarps - 1) / kWarps;
    chain_wide_kernel<<<blocks, kWarps * 32, shmem, s>>>(a);
  }
  fgdp_record(ev_end, s);
  return (int)cudaGetLastError();
}
