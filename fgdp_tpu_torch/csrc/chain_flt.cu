// The chain filter (mem_chain_flt) for Hopper (sm_90a).
//
// Replaces the JAX package's device loop fgdp_tpu/align/chain.py:342
// _chain_flt (D5: two stable argsorts, the lax.while_loop over the
// filter ranks at :416, the shadow scatter, the max_chain_extend cumsum
// and the scatter back to insertion order), which the port ran as a
// Python loop of about 20 torch ops a rank after a host sync for the
// batch's largest rank count. The logic per read is chain_flt.cuh.
//
// Design: one warp a read, its chains in the warp's shared memory (40
// bytes a chain slot: 2.5 KB at C = 64, 15 KB at C = 384); up to four
// reads a block, fewer where their tables would not fit. The order is
// an exact count of smaller keys, each rank step one pass of the lanes
// over the ranks before it with ballots, the cut a warp scan: no sort,
// no host test, one launch a batch.
//
// What bounds it: the longest read's chain of rank steps (its n_f - 1
// steps of ceil(i / 32) passes, each a few shared loads, two float
// multiplies and two ballots), once the fields are read: the bytes are
// 6 ints of each of the batch's chains and the B x C flags written, a
// few MB, microseconds at the card's memory rate.
#include <cuda_runtime.h>

#include "chain_flt.cuh"

constexpr int kFltWarps = 4;   // reads a block, at most

__global__ void __launch_bounds__(kFltWarps * 32)
    chain_flt_kernel(FltArgs a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;   // uniform per warp
  WarpLanes L;
  chain_flt_read(a, b, smem + (size_t)warp * FLT_NARR * a.C, L);
}

static int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// the widest C one block's shared memory holds (one read a block):
// 5,811 on an H100 (227 KB a block)
extern "C" int fgdp_chain_flt_max_c() {
  return smem_optin() / (FLT_NARR * (int)sizeof(int));
}

// n int32[B]; pos, crid, fq, lq, ll, weight int32[B, C] (P2's table and
// min(wq, wr)); is_alt bool[n_contigs] -> kept int32[B, C], every slot
// written. ev_start/ev_end are cudaEvent_t or null, recorded on
// `stream` right around the launch. Returns cudaErrorInvalidValue for a
// C above fgdp_chain_flt_max_c(), else cudaGetLastError().
extern "C" int fgdp_chain_flt(const int* n, const int* pos, const int* crid,
                              const int* fq, const int* lq, const int* ll,
                              const int* weight,
                              const unsigned char* is_alt, int n_contigs,
                              int B, int C, int min_chain_weight,
                              int min_seed_len, int max_chain_gap,
                              int max_chain_extend, float mask_level,
                              float drop_ratio, int* kept, void* ev_start,
                              void* ev_end, void* stream) {
  if (C < 1 || B < 0 || n_contigs < 0) return (int)cudaErrorInvalidValue;
  const size_t per_read = (size_t)FLT_NARR * C * sizeof(int);
  const size_t optin = (size_t)smem_optin();
  if (per_read > optin) return (int)cudaErrorInvalidValue;
  const int warps = (int)(optin / per_read < (size_t)kFltWarps
                              ? optin / per_read : kFltWarps);
  const size_t shmem = per_read * warps;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chain_flt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  FltArgs a{n, pos, crid, fq, lq, ll, weight, is_alt, n_contigs, B, C,
            min_chain_weight, min_seed_len, max_chain_gap,
            max_chain_extend, mask_level, drop_ratio, kept};
  cudaStream_t s = (cudaStream_t)stream;
  fgdp_record(ev_start, s);
  if (B > 0) {
    const int blocks = (B + warps - 1) / warps;
    chain_flt_kernel<<<blocks, warps * 32, shmem, s>>>(a);
  }
  fgdp_record(ev_end, s);
  return (int)cudaGetLastError();
}
