// Seed-chaining loop kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fgdp_tpu/ops/chain_pallas.py (_kernel, launched
// by chain_loop_pallas): per read, seeds are inserted in slot order into
// a C-slot chain table (contained -> dropped, growable -> appended, else
// a new chain), with the wq/wr weights, each seed's chain id and the
// overflow flag when all C slots are used.
//
// Design: one warp per read. The read's chain table (12 fields x C
// slots) lives in shared memory; slot c belongs to lane c % 32. Seeds
// stream in from global memory in slot order up to the read's last
// valid slot. "Largest pos <= rbeg, ties to the latest slot" is two
// warp max-reductions (over pos, then over the slot index among the
// ties); the rest of a step is integer work on the chosen slot, done
// identically by every lane, with lane 0 writing the table. It takes
// every shape the escalation ladder produces (P up to 2048, C up to 256:
// 12 KB of shared memory per warp); the TPU kernel's VMEM tile fit has
// no counterpart.
//
// What bounds it: the bytes. Each step is a few dozen integer
// operations per lane, so the seed columns read (5 words per slot up to
// the read's last valid slot) and the table and chain ids written set
// the least time; the serial chain of steps inside a read, each waiting
// on two shuffle reductions, is what this simple design pays for.
#include <cuda_runtime.h>

#include "chain_loop.cuh"

// the warp's lanes; host passes of nvcc see the same declarations, but
// only device code ever instantiates chain_read with them
struct WarpLanes {
  __host__ __device__ int lane() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x & 31;
#else
    return 0;
#endif
  }
  __host__ __device__ int width() const { return 32; }
  __host__ __device__ int max(int v) const {
#ifdef __CUDA_ARCH__
    return __reduce_max_sync(0xffffffffu, v);
#else
    return v;
#endif
  }
  __host__ __device__ bool any(bool v) const {
#ifdef __CUDA_ARCH__
    return __any_sync(0xffffffffu, v);
#else
    return v;
#endif
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

constexpr int kWarps = 2;   // reads per block

__global__ void chain_loop_kernel(ChainArgs a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.B) return;   // uniform per warp
  WarpLanes L;
  chain_read(a, b, smem + warp * CH_NFIELDS * a.C, L);
}

// qbeg/rbeg/slen/rid int32[B, P], valid bool[B, P], ovf_in bool[B] ->
// out int32[10, B, C] (pos, crid, fq, fr, lq, lr, ll, ns, wq, wr),
// n_out int32[B], ovf_out bool[B], chain_of int32[B, P]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int fgdp_chain_loop(const int* qbeg, const int* rbeg,
                               const int* slen, const int* rid,
                               const unsigned char* valid,
                               const unsigned char* ovf_in, int B, int P,
                               int C, int l_pac, int w, int max_chain_gap,
                               int* out, int* n_out, unsigned char* ovf_out,
                               int* chain_of, void* stream) {
  ChainArgs a{qbeg, rbeg, slen, rid, valid, ovf_in, B, P, C, l_pac, w,
              max_chain_gap, out, n_out, ovf_out, chain_of};
  if (B > 0) {
    const size_t shmem = (size_t)kWarps * CH_NFIELDS * C * sizeof(int);
    if (shmem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          chain_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)shmem);
      if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (B + kWarps - 1) / kWarps;
    chain_loop_kernel<<<blocks, kWarps * 32, shmem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
