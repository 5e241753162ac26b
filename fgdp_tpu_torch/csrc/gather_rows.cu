// Row gather for Hopper (sm_90a): out[i, :] = tbl[idx[i], :].
//
// Replaces the TPU kernel scripts/bench_gather_pallas.py (gather_kernel,
// built by make): one DMA per row from the table in HBM to the output,
// with D copies in flight. It measures the rate of the random row reads
// that bound the FM-index rank lookups.
//
// Design: one warp per group of D consecutive output rows. Lane l < D
// reads the group's l-th index; the warp then walks each row in 512-byte
// chunks, one 16-byte load per lane (a 128-int32 row is one chunk), and
// issues the loads of all D rows into registers before it stores any of
// them, so each warp keeps D row reads in flight, as the TPU kernel keeps
// D DMAs. D is a template parameter (1 to 32), so the D loads unroll into
// registers. The wrapper checks the indices, the row width (a multiple
// of 4 int32) and the 16-byte alignment before it launches.
//
// What bounds it: bytes. Each output row reads one table row and writes
// one row, plus 4 bytes of index; a table larger than the 50 MB L2
// (the probe's is 64 MB) makes the reads come from HBM.
#include <cuda_runtime.h>

template <int D>
__global__ void gather_rows_kernel(const int4* __restrict__ tbl,
                                   const int* __restrict__ idx,
                                   int4* __restrict__ out, long long n,
                                   int w4) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = warp * D;
  if (r0 >= n) return;                       // whole warps leave together
  const int mine = (lane < D && r0 + lane < n) ? idx[r0 + lane] : 0;
  int rows[D];
#pragma unroll
  for (int d = 0; d < D; ++d) rows[d] = __shfl_sync(0xffffffffu, mine, d);
  for (int c = lane; c - lane < w4; c += 32) {
    int4 v[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (r0 + d < n && c < w4) v[d] = tbl[(long long)rows[d] * w4 + c];
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (r0 + d < n && c < w4) out[(r0 + d) * w4 + c] = v[d];
  }
}

template <int D>
static void launch(const void* tbl, const int* idx, void* out, long long n,
                   int w4, cudaStream_t stream) {
  const int threads = 256;
  const long long warps = (n + D - 1) / D;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  gather_rows_kernel<D><<<(unsigned)blocks, threads, 0, stream>>>(
      (const int4*)tbl, idx, (int4*)out, n, w4);
}

// tbl: int32[rows, w] on the card, w a multiple of 4, 16-byte aligned;
// idx: int32[n], each in [0, rows) (the wrapper checks); out:
// int32[n, w]. depth (D) in {1, 2, 4, 8, 16, 32}. Launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for another
// depth or a width that is not a multiple of 4.
extern "C" int fgdp_gather_rows(const void* tbl, const int* idx, void* out,
                                long long n, int w, int depth,
                                void* stream) {
  if (w <= 0 || w % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int w4 = w / 4;
  cudaStream_t s = (cudaStream_t)stream;
  switch (depth) {
    case 1: launch<1>(tbl, idx, out, n, w4, s); break;
    case 2: launch<2>(tbl, idx, out, n, w4, s); break;
    case 4: launch<4>(tbl, idx, out, n, w4, s); break;
    case 8: launch<8>(tbl, idx, out, n, w4, s); break;
    case 16: launch<16>(tbl, idx, out, n, w4, s); break;
    case 32: launch<32>(tbl, idx, out, n, w4, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
