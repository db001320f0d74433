// Stepped SYRK for Hopper (sm_90a), f64: the lower block triangle of
// F = Y^T Y for a stepped Y, batched over subdomains.
//
// Replaces: repro/kernels/stepped_syrk.py::stepped_syrk_pallas (body
// _syrk_kernel), the TPU kernel of paper §3.3.
//
// What bounds it: the useful work is SteppedMeta.flops_syrk_output_split()
// per subdomain, times S (about 0.02 TFLOP on feti-heat-2d's 64 subdomains),
// against the card's FP64 peak: 67 TFLOP/s through the FP64 tensor cores,
// 34 TFLOP/s through plain FP64 FMA (NVIDIA H100 SXM data sheet). It must
// also read Y below each stripe's start once (~0.9 GB at full size, ~0.3 ms
// at 3.35 TB/s), so operations and bytes bound it about equally; the
// caller's TRSM does over ten times its work.
//
// What the design does about it (the device code is stepped_syrk.cuh):
//   * Only the lower tiles (i, j <= i) of the bm x bm tile grid are
//     launched (blockIdx.x enumerates them); the upper tiles are never
//     touched and keep the zeros the wrapper allocated, which the mirror
//     step relies on.
//   * Tile (i, j) reduces over factor rows from stripe i's start block
//     only (paper's k-dimension reduction): pivots are sorted, so stripe
//     i's columns of Y are zero above it.
//   * Each block computes a 32 x 32 sub-tile of one tile (16 per 128-wide
//     tile, 6144 blocks at full size), streaming 32-row chunks of the two
//     Y column panels through shared memory; each thread keeps 4 outputs.
//   * Plain f64 FMA, no DMMA, no TMA: a simple kernel that is right.
//
// Layout: row-major, Y (S, n, m), F (S, m, m), start_block (m / bm,) int32.
// n is padded to a bs multiple, m to a bm multiple, bm a multiple of 32.

#include "stepped_syrk.cuh"

namespace {

using namespace stepped;

__global__ void __launch_bounds__(SYRK_THREADS)
stepped_syrk_kernel(const double* __restrict__ Y,
                    const int* __restrict__ start_block,
                    double* __restrict__ F, int n, int m, int bs, int bm) {
  __shared__ double smem[SYRK_SMEM_BYTES / sizeof(double)];
  int ti, tj;
  lower_tile(blockIdx.x, ti, tj);
  const int subs = bm / T;
  const int r0 = ti * bm + (blockIdx.y / subs) * T;  // F rows = Y columns
  const int c0 = tj * bm + (blockIdx.y % subs) * T;  // F columns
  const int64_t s = blockIdx.z;
  syrk_subtile<LoadInput>(Y + s * (int64_t)n * m, F + s * (int64_t)m * m, n,
                          m, start_block[ti] * bs, r0, c0, smem);
}

}  // namespace

extern "C" int stepped_syrk_f64(const void* Y, const void* start_block,
                                void* F, int S, int n, int m, int bs, int bm,
                                void* stream) {
  const int nc = m / bm;
  const int subs = bm / T;
  dim3 grid(nc * (nc + 1) / 2, subs * subs, S);
  stepped_syrk_kernel<<<grid, SYRK_THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)Y, (const int*)start_block, (double*)F, n, m, bs, bm);
  return (int)cudaGetLastError();
}
