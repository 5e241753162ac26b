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

FGDP_HD int fgdp_min(int a, int b) { return a < b ? a : b; }
FGDP_HD int fgdp_max(int a, int b) { return a > b ? a : b; }

// floor division for b > 0 (C++ '/' truncates toward zero; the JAX
// package's '//' floors)
FGDP_HD int fgdp_floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}
