// Issue-rate probe kernels for Hopper (sm_90a): FP32 FMA chains and their
// INT32 twin.
//
// Replaces the TPU kernel scripts/bench_vpu_ceiling.py (kernel, built by
// mk_kernel, launched per chain count): every element of a float32 array
// runs `steps` steps of NCH independent multiply-add chains (64 FMAs a
// step), the instruction-level-parallelism sweep that measures the vector
// issue ceiling. The INT32 twin runs chains of wrapping add, subtract and
// max (a banded-SW cell's operation mix), the rate that the SW kernel's
// bound divides by.
//
// Design: one thread per element, the NCH chains in registers (NCH is a
// template parameter, so the chains unroll), the constants in the kernel
// parameters (constant bank operands of FFMA). Each thread reads its
// element once and writes it once; between them it issues only the
// chains' arithmetic, so the kernel's time is the card's issue rate for
// the chosen ILP. -fmad=false (NVCC_FLAGS) keeps the scale multiply and
// the chain sums unfused; the chain step is an explicit fmaf.
//
// What bounds it: operations. Per element and step 64 FMAs (128 FLOPs)
// plus NCH multiplies and NCH - 1 adds; the INT32 twin 3 x 64 operations
// plus NCH xors and NCH - 1 adds. The bytes (8 per element) are
// negligible against them.
#include <cuda_runtime.h>

#include "vpu_ceiling.cuh"

template <int NCH>
__global__ void vpu_fp32_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long n,
                                int steps, VpuConsts k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = vpu_fp32_element<NCH>(x[i], steps, k);
}

template <int NCH>
__global__ void vpu_int32_kernel(const int* __restrict__ x,
                                 int* __restrict__ out, long long n,
                                 int steps, VpuConsts k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = vpu_int32_element<NCH>(x[i], steps, k);
}

template <int NCH>
static void launch(const void* x, void* out, long long n, int steps,
                   int is_int, const VpuConsts& k, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (is_int)
    vpu_int32_kernel<NCH><<<(unsigned)blocks, threads, 0, stream>>>(
        (const int*)x, (int*)out, n, steps, k);
  else
    vpu_fp32_kernel<NCH><<<(unsigned)blocks, threads, 0, stream>>>(
        (const float*)x, (float*)out, n, steps, k);
}

// x, out: n float32 (is_int = 0) or int32 (is_int = 1) values on the
// card; scale/mul/add/seed/a/b: host arrays of VPU_MAX_CHAINS constants.
// n_chains in {4, 8, 16}. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for another chain count.
extern "C" int fgdp_vpu_ceiling(const void* x, void* out, long long n,
                                int steps, int n_chains, int is_int,
                                const float* scale, const float* mul,
                                const float* add, const int* seed,
                                const int* a, const int* b, void* stream) {
  VpuConsts k;
  for (int i = 0; i < VPU_MAX_CHAINS; ++i) {
    k.scale[i] = scale[i];
    k.mul[i] = mul[i];
    k.add[i] = add[i];
    k.seed[i] = seed[i];
    k.a[i] = a[i];
    k.b[i] = b[i];
  }
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_chains) {
    case 4: launch<4>(x, out, n, steps, is_int, k, s); break;
    case 8: launch<8>(x, out, n, steps, is_int, k, s); break;
    case 16: launch<16>(x, out, n, steps, is_int, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
