// Fused stepped TRSM -> SYRK for Hopper (sm_90a), f64: the lower block
// triangle of F = (L^{-1} B)^T (L^{-1} B) in one launch, batched over
// subdomains, against a dense or a packed factor.
//
// Replaces:
//   * stepped_trsm_syrk_f64:
//     repro/kernels/stepped_trsm_syrk.py::stepped_trsm_syrk_pallas (body
//     _fused_kernel);
//   * stepped_trsm_syrk_packed_f64:
//     repro/kernels/stepped_trsm_syrk.py::stepped_trsm_syrk_packed_pallas
//     (body _fused_packed_kernel), the same with the packed factor's
//     forward substitution.
//
// What bounds them: the f64 operations of the TRSM half (see
// stepped_trsm.cu), about ten times those of the SYRK half; the bytes that
// must move are the factor, Linv, B and F (Y need not leave the chip).
//
// The TPU kernel runs its (nc, nc) grid sequentially in row-major order:
// program (c, 0) solves stripe c into a persistent VMEM scratch and every
// later program (c, j <= c) reads stripes c and j from it. CUDA blocks run
// in no order, so readiness has to be explicit. Chosen: ONE cooperative
// launch (cudaLaunchCooperativeKernel) of a persistent grid, no larger than
// what is co-resident, with one grid-wide barrier between the phases:
//   1. TRSM phase: the blocks stride over the (subdomain, 32-column tile)
//      items and run stepped_trsm.cuh's forward substitution into a
//      global Y scratch (S, n, m), exactly as the stepped TRSM does;
//   2. grid.sync() — every Y tile is written and visible (the barrier
//      orders memory);
//   3. SYRK phase: the blocks stride over the (subdomain, lower tile,
//      32 x 32 sub-tile) items and run stepped_syrk.cuh's sub-tile
//      product, reading the scratch with ld.global.cg (L2, never a stale
//      L1 line; never the read-only path, which assumes the data does not
//      change during the launch).
// Why this over per-stripe ready flags with an atomic ticket: no block
// ever spins on another, so no schedule can deadlock (the cooperative
// launch refuses a grid that cannot be co-resident instead of hanging),
// there is nothing to zero before a launch, and both phases reuse the
// unfused kernels' device code, so the fused result equals the stepped
// TRSM -> stepped SYRK pair's. The cost is that no SYRK tile starts before
// the last TRSM tile ends; per-stripe flags would overlap them, a later
// optimization.
//
// Upper tiles (j > i) are never written: the wrapper allocates F as zeros,
// which the mirror step relies on. Plain f64 FMA, no DMMA, no TMA.
//
// Layout: as stepped_trsm.cu, plus the scratch Y (S, n, m) and the output
// F (S, m, m); bs a multiple of 32 up to 128, bm a multiple of 32.

#include <cooperative_groups.h>

#include "stepped_syrk.cuh"
#include "stepped_trsm.cuh"

namespace {

using namespace stepped;

constexpr size_t SMEM_BYTES =
    TRSM_SMEM_BYTES > SYRK_SMEM_BYTES ? TRSM_SMEM_BYTES : SYRK_SMEM_BYTES;
static_assert(THREADS == SYRK_THREADS, "both phases run on the same block");

template <class Factor>
__global__ void __launch_bounds__(THREADS)
stepped_trsm_syrk_kernel(Factor fac, const double* __restrict__ Linv,
                         const double* __restrict__ B,
                         const int* __restrict__ start_block, double* Y,
                         double* __restrict__ F, int S, int n, int m, int bs,
                         int bm) {
  extern __shared__ double smem[];
  const int nb = n / bs;

  // 1. TRSM phase: Y = L^{-1} B, one 32-column tile per item
  const int col_tiles = m / TN;
  const int64_t trsm_items = (int64_t)S * col_tiles;
  for (int64_t it = blockIdx.x; it < trsm_items; it += gridDim.x) {
    const int64_t s = it / col_tiles;
    const int col0 = (int)(it % col_tiles) * TN;
    const int start = min(start_block[col0 / bm], nb);
    solve_column_tile(fac, Linv, B, Y, s, col0, start, n, m, bs, smem);
  }

  // 2. every stripe of Y is solved and visible to every block
  cooperative_groups::this_grid().sync();

  // 3. SYRK phase: lower tiles (i, j <= i) of Y^T Y, one sub-tile per item
  const int nc = m / bm, subs = bm / T;
  const int per_tile = subs * subs;
  const int per_sub = nc * (nc + 1) / 2 * per_tile;
  const int64_t syrk_items = (int64_t)S * per_sub;
  for (int64_t it = blockIdx.x; it < syrk_items; it += gridDim.x) {
    const int64_t s = it / per_sub;
    const int rem = (int)(it % per_sub);
    int ti, tj;
    lower_tile(rem / per_tile, ti, tj);
    const int sub = rem % per_tile;
    const int r0 = ti * bm + (sub / subs) * T;
    const int c0 = tj * bm + (sub % subs) * T;
    syrk_subtile<LoadFromL2>(Y + s * (int64_t)n * m, F + s * (int64_t)m * m,
                             n, m, min(start_block[ti], nb) * bs, r0, c0,
                             smem);
  }
}

template <class Factor>
int launch(Factor fac, const void* Linv, const void* B,
           const void* start_block, void* Y, void* F, int S, int n, int m,
           int bs, int bm, void* stream) {
  auto kernel = stepped_trsm_syrk_kernel<Factor>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int nc = m / bm, subs = bm / T;
  const int64_t trsm_items = (int64_t)S * (m / TN);
  const int64_t syrk_items = (int64_t)S * (nc * (nc + 1) / 2) * subs * subs;
  const int64_t items = trsm_items > syrk_items ? trsm_items : syrk_items;
  const int64_t resident = (int64_t)per_sm * sms;
  const int grid = (int)(items < resident ? items : resident);

  const double* linv = (const double*)Linv;
  const double* b = (const double*)B;
  const int* starts = (const int*)start_block;
  double* y = (double*)Y;
  double* f = (double*)F;
  void* args[] = {&fac, &linv, &b, &starts, &y, &f, &S, &n, &m, &bs, &bm};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(THREADS), args, SMEM_BYTES,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stepped_trsm_syrk_f64(const void* Linv, const void* L,
                                     const void* B, const void* start_block,
                                     void* Y, void* F, int S, int n, int m,
                                     int bs, int bm, void* stream) {
  return launch(DenseFactor{(const double*)L, n}, Linv, B, start_block, Y, F,
                S, n, m, bs, bm, stream);
}

extern "C" int stepped_trsm_syrk_packed_f64(
    const void* Linv, const void* values, const void* rowptr,
    const void* colidx, const void* B, const void* start_block, void* Y,
    void* F, int S, int n, int m, int bs, int bm, int n_blocks, void* stream) {
  return launch(PackedFactor{(const double*)values, (const int*)rowptr,
                             (const int*)colidx, n_blocks},
                Linv, B, start_block, Y, F, S, n, m, bs, bm, stream);
}
