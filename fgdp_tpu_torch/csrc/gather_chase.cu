// Dependent-gather latency probe for Hopper (sm_90a): the serial bounds
// of the seeding kernels (K1, K2, K3), independent of their designs. No
// TPU kernel corresponds to it.
//
// A chain runs `hops` dependent hops. A hop gathers two whole 96-byte
// checkpoint rows of an FM occ table (int32[nblocks, 24]: rows p and q,
// six 16-byte loads each, all twelve in flight together, as a seeding
// step reads the rows at l and l + s) and takes the next pair from what
// it read: x = the int32 sum (wrapping) of the 48 ints, p' = ((x & 0x7fffffff)
// 40503 + hop) % nblocks, q' = min(p' + ((x >> 8) & 3), nblocks - 1).
// One thread a chain; the chain's last x and p are its output, which the
// plain version (probes/chase.py, torch ops) gives alike. With `sync` the
// launch is cooperative and every thread of the grid passes one grid
// barrier after each hop: sync 1 cooperative_groups' grid sync (the
// first K1 and K2 kernels' barrier), sync 2 the K1 and K2 kernels'
// hand-written GridBar (seed_waves.cuh) with a count of one a block, in
// the form (one word or two) the kernels take for blocks x threads
// lanes, sync 3 GridBar's two-word (wide) form at any grid; with chains
// = 0 it times the barriers alone.
//
// What bounds it: by design, the latency of one hop (a dependent gather
// of two rows from L2 or device memory) times the hops; the bytes (192 a
// hop) are nothing at the card's memory rate.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "seed_waves.cuh"

// SYNC: 0 no barrier, 1 cooperative_groups' grid sync, 2 GridBar, 3
// GridBar wide (a template argument, so the lone chain's hop loop
// carries no barrier)
template <int SYNC>
__global__ void gather_chase_kernel(const int4* __restrict__ occ,
                                    long long nblocks, int chains, int hops,
                                    long long p0, int* out,
                                    unsigned long long* slots) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  GridBar g{slots, nullptr, nullptr,
            SYNC == 2 &&
                (long long)gridDim.x * blockDim.x < SEED_NARROW_LANES &&
                gridDim.x < (1u << 13)};
  long long p = (p0 + 7919LL * t) % nblocks;
  long long q = p + 1 < nblocks ? p + 1 : p;
  int x = 0;
  for (int h = 0; h < hops; ++h) {
    if (t < chains) {
      int4 a[6], b[6];
#pragma unroll
      for (int w = 0; w < 6; ++w) {
        a[w] = __ldcg(occ + p * 6 + w);
        b[w] = __ldcg(occ + q * 6 + w);
      }
      unsigned s = 0;
#pragma unroll
      for (int w = 0; w < 6; ++w)
        s += (unsigned)a[w].x + (unsigned)a[w].y + (unsigned)a[w].z +
             (unsigned)a[w].w + (unsigned)b[w].x + (unsigned)b[w].y +
             (unsigned)b[w].z + (unsigned)b[w].w;
      x = (int)s;
      p = ((long long)(s & 0x7fffffffu) * 40503 + h) % nblocks;
      q = p + ((s >> 8) & 3);
      if (q > nblocks - 1) q = nblocks - 1;
    }
    if constexpr (SYNC == 1)
      cooperative_groups::this_grid().sync();
    else if constexpr (SYNC >= 2)
      g.sync();
  }
  if (t < chains) {
    out[2 * t] = x;
    out[2 * t + 1] = (int)p;
  }
}

// occ int32[nblocks, 24] (16-byte aligned); out int32[chains, 2]; chains
// <= blocks x threads. sync 1, 2 or 3 launches cooperatively (all
// blocks resident, else cudaErrorCooperativeLaunchTooLarge); sync 2 and
// 3 need slots, int64[6] zeroed (GridBar's), else null. ev_start/ev_end
// are cudaEvent_t or null, recorded on `stream` just before and just
// after the launch. Returns cudaGetLastError() or the launch's error, or
// cudaErrorInvalidValue for a bad shape.
extern "C" int fgdp_gather_chase(const int* occ, long long nblocks,
                                 int chains, int hops, int blocks,
                                 int threads, int sync, long long p0,
                                 int* out, unsigned long long* slots,
                                 void* ev_start, void* ev_end,
                                 void* stream) {
  if (nblocks < 1 || chains < 0 || hops < 0 || blocks < 1 || threads < 1 ||
      (long long)chains > (long long)blocks * threads || p0 < 0 ||
      sync < 0 || sync > 3 || (sync >= 2 && (slots == nullptr ||
                                            threads % 32 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int4* o = reinterpret_cast<const int4*>(occ);
  int rc = 0;
  fgdp_record(ev_start, s);
  if (sync) {
    void* args[] = {&o, &nblocks, &chains, &hops, &p0, &out, &slots};
    rc = (int)cudaLaunchCooperativeKernel(
        sync == 1   ? (void*)gather_chase_kernel<1>
        : sync == 2 ? (void*)gather_chase_kernel<2>
                    : (void*)gather_chase_kernel<3>,
        blocks, threads, args, 0, s);
  } else {
    gather_chase_kernel<0><<<blocks, threads, 0, s>>>(o, nblocks, chains,
                                                      hops, p0, out, slots);
  }
  fgdp_record(ev_end, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
