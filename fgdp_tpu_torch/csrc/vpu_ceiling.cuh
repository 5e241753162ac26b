// Issue-rate probe for ONE element: the per-thread logic of the
// vpu_ceiling kernels (vpu_ceiling.cu), also built on the host by
// host_twin.cc for the CPU tests.
//
// FP32: the body of the TPU kernel scripts/bench_vpu_ceiling.py (kernel,
// built by mk_kernel): per step, NCH chains start as acc * scale[k], run
// 64 / NCH rounds of c = c * mul[k] + add[k], one fused multiply-add
// each, and sum back into acc in chain order. INT32: the same chain
// shape with the operation mix of a banded-SW cell (sw_extend.cuh):
// chains start as acc ^ seed[k], each round is an add, a subtract and a
// max, c = max(c + a[k], c - b[k]), all wrapping, and the chains sum
// back with wrapping adds.
//
// The constants come from the caller, so the plain PyTorch versions use
// the very same float32 values.
#pragma once

#include <math.h>

#include "common.cuh"

#define VPU_MAX_CHAINS 16
#define VPU_OPS_PER_STEP 64   // chain rounds x chains: FMAs (or max-rounds)

struct VpuConsts {
  float scale[VPU_MAX_CHAINS], mul[VPU_MAX_CHAINS], add[VPU_MAX_CHAINS];
  int seed[VPU_MAX_CHAINS], a[VPU_MAX_CHAINS], b[VPU_MAX_CHAINS];
};

FGDP_HD int vpu_wrap_add(int x, int y) {
  return (int)((unsigned)x + (unsigned)y);
}

FGDP_HD int vpu_wrap_sub(int x, int y) {
  return (int)((unsigned)x - (unsigned)y);
}

template <int NCH>
FGDP_HD float vpu_fp32_element(float x, int steps, const VpuConsts& k) {
  float acc = x;
  for (int s = 0; s < steps; ++s) {
    float c[NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) c[i] = acc * k.scale[i];
#pragma unroll
    for (int r = 0; r < VPU_OPS_PER_STEP / NCH; ++r) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) c[i] = fmaf(c[i], k.mul[i], k.add[i]);
    }
    float t = c[0];
#pragma unroll
    for (int i = 1; i < NCH; ++i) t = t + c[i];
    acc = t;
  }
  return acc;
}

template <int NCH>
FGDP_HD int vpu_int32_element(int x, int steps, const VpuConsts& k) {
  int acc = x;
  for (int s = 0; s < steps; ++s) {
    int c[NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) c[i] = acc ^ k.seed[i];
#pragma unroll
    for (int r = 0; r < VPU_OPS_PER_STEP / NCH; ++r) {
#pragma unroll
      for (int i = 0; i < NCH; ++i)
        c[i] = fgdp_max(vpu_wrap_add(c[i], k.a[i]),
                        vpu_wrap_sub(c[i], k.b[i]));
    }
    int t = c[0];
#pragma unroll
    for (int i = 1; i < NCH; ++i) t = vpu_wrap_add(t, c[i]);
    acc = t;
  }
  return acc;
}
