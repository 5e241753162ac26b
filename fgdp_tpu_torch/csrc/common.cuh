// Shared helpers for the port's hand-written kernels. The per-job and
// per-read step logic is written once as FGDP_HD functions: nvcc builds
// it into the sm_90a kernels, and g++ builds the same text into a host
// twin (host_twin.cc) that the CPU tests hold against the plain PyTorch
// versions. The twin is a test aid only; the port's CPU path runs the
// plain PyTorch versions.
#pragma once

#ifdef __CUDACC__
#define FGDP_HD __host__ __device__ __forceinline__
#else
#define FGDP_HD inline
#endif

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Records a launch's timing event `ev` (a cudaEvent_t; none when null) on
// stream `s`. While `s` is being captured into a CUDA graph the record is
// an external node of the graph, so that every replay records it again.
static inline void fgdp_record(void* ev, cudaStream_t s) {
  if (ev == nullptr) return;
  cudaStreamCaptureStatus st = cudaStreamCaptureStatusNone;
  if (cudaStreamIsCapturing(s, &st) == cudaSuccess &&
      st == cudaStreamCaptureStatusActive)
    cudaEventRecordWithFlags((cudaEvent_t)ev, s, cudaEventRecordExternal);
  else
    cudaEventRecord((cudaEvent_t)ev, s);
}
#endif

FGDP_HD int fgdp_min(int a, int b) { return a < b ? a : b; }
FGDP_HD int fgdp_max(int a, int b) { return a > b ? a : b; }

// floor division for b > 0 (C++ '/' truncates toward zero; the JAX
// package's '//' floors)
FGDP_HD int fgdp_floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// index of the lowest set bit of x != 0
FGDP_HD int fgdp_ctz(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// set bits of x
FGDP_HD int fgdp_popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// read-only gathers of the seeding kernels' tables: through the
// read-only data cache on the card
FGDP_HD int fgdp_ld(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// four ints at a 16-byte aligned address
FGDP_HD void fgdp_ld4(const int* p, int o[4]) {
#ifdef __CUDA_ARCH__
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
#else
  for (int t = 0; t < 4; ++t) o[t] = p[t];
#endif
}

// a 24-int row at a 16-byte aligned address
FGDP_HD void fgdp_ld_row24(const int* p, int o[24]) {
  for (int t = 0; t < 6; ++t) fgdp_ld4(p + 4 * t, o + 4 * t);
}

#ifdef __CUDACC__
// A warp's 32 lanes, for the kernels' per-job logic (its host twin passes
// a serial lane, or 32 lanes in lockstep, instead). A lane value (I) is
// the thread's own int. Host passes of nvcc see the same declarations,
// but only device code ever instantiates the logic with them.
struct WarpLanes {
  using I = int;
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
  __host__ __device__ int min(int v) const {
#ifdef __CUDA_ARCH__
    return __reduce_min_sync(0xffffffffu, v);
#else
    return v;
#endif
  }
  // v of lane - d (a lane below d keeps its own v)
  __host__ __device__ int shfl_up(int v, int d) const {
#ifdef __CUDA_ARCH__
    return __shfl_up_sync(0xffffffffu, v, d);
#else
    return v;
#endif
  }
  // v of lane src, for every lane
  __host__ __device__ int shfl(int v, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, v, src);
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
  // bit l set where lane l's c holds
  __host__ __device__ unsigned ballot(bool c) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xffffffffu, c);
#else
    return c ? 1u : 0u;
#endif
  }
  // the one lane that writes what every lane computed alike
  __host__ __device__ bool lead() const { return lane() == 0; }
  __host__ __device__ int sel(bool c, int a, int b) const {
    return c ? a : b;
  }
  __host__ __device__ int load(const int* p, int idx, bool ok,
                               int other) const {
    return ok ? p[idx] : other;
  }
  __host__ __device__ int load_u8(const unsigned char* p, int idx,
                                  bool ok) const {
    return ok ? p[idx] : 0;
  }
  __host__ __device__ void store_if(int* p, int idx, int v, bool ok) const {
    if (ok) p[idx] = v;
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};
#endif
