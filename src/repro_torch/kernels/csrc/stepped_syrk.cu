// Stepped SYRK for Hopper (sm_90a), f64 and f32: the lower block triangle
// of F = Y^T Y for a stepped Y, batched over subdomains.
//
// Replaces: repro/kernels/stepped_syrk.py::stepped_syrk_pallas (body
// _syrk_kernel), the TPU kernel of paper §3.3: stepped_syrk_f64 at f64,
// stepped_syrk_f32 at f32 and for bf16 storage, whose prep runs at f32
// (the TPU kernel accumulates sub-f64 inputs in f32; so does this one, on
// FFMA).
//
// What bounds it (f64): the useful work is
// SteppedMeta.flops_syrk_output_split() per subdomain, times S (about 0.011 TFLOP on feti-heat-2d's 64
// subdomains), 0.17 ms at the FP64 tensor cores' 67 TFLOP/s (NVIDIA H100
// SXM data sheet; plain FP64 FMA peaks at half that). It must also read Y
// below each stripe's start once (~0.5 GB at full size, ~0.16 ms at
// 3.35 TB/s), so operations and bytes bound it about equally; the
// caller's TRSM does over ten times its work. At 245 registers a thread
// the 128 x 128 sub-tile runs one block (8 warps) a SM. Per 16-row chunk
// its shared-memory traffic (32 KB copied in, 96 KB of fragments loaded)
// and its 256 m16n8k8 products take about the same 1,000 SM clocks, and
// the 384 blocks at full size are three uneven waves; it runs near 30% of
// the bound (PERF.md).
//
// What the design does about it (the device code is stepped_syrk.cuh):
//   * Only the lower tiles (i, j <= i) of the bm x bm tile grid are
//     launched; the upper tiles are never touched and keep the zeros the
//     wrapper allocated, which the mirror step relies on.
//   * Tile (i, j) reduces over factor rows from stripe i's start block
//     only (paper's k-dimension reduction): pivots are sorted, so stripe
//     i's columns of Y are zero above it.
//   * Each block computes one 128 x 128 sub-tile of one tile (clipped to
//     the tile when bm is smaller) on the FP64 tensor cores (mma.sync
//     m16n8k8, 8 warps of 64 x 32), streaming 16-row chunks of the two Y
//     column panels through a 3-stage cp.async ring. A warp loads 8 + 4
//     fragments for every 16 products, so shared memory keeps up with the
//     tensor cores; the price is registers (one block a SM).
//   * Blocks are numbered tile-major, so the tiles of the first stripes,
//     which reduce over the most rows, start first (start blocks are
//     non-decreasing); the sub-tiles of one tile are neighbours and share
//     their panels in L2.
//   * f32: the same schedule with the products on FFMA (ffma_f32.cuh).
//     The least time of its work is the f32 operations at 3xTF32's rate
//     (three TF32 tensor-core products at 494.7 TFLOP/s each, what the
//     f32 TRSM core runs) or half the f64 bytes; a 3xTF32 SYRK tile is
//     queued (ROADMAP).
//
// Layout: row-major, Y (S, n, m), F (S, m, m), start_block (m / bm,) int32,
// every array 16-byte aligned (the wrapper checks). n is padded to a bs
// multiple (any bs: the last 16-row chunk is clipped to n), m to a bm
// multiple, bm a multiple of 8 (a tile narrower than the 128 x 128
// sub-tile is computed whole and clipped at its store: simple, and only
// the smoke configurations' bm = 8 pays for it).

#include "stepped_syrk.cuh"

namespace {

using namespace stepped;

// 128 x 128 sub-tiles on 8 warps of 64 x 32 measured faster than 64 x 64
// sub-tiles on 8 warps of 32 x 16 (PERF.md)
constexpr int SUB = 128, WARP_M = 64, WARP_N = 32;

template <class T>
__global__ void __launch_bounds__(SYRK_THREADS)
stepped_syrk_kernel(const T* __restrict__ Y,
                    const int* __restrict__ start_block, T* __restrict__ F,
                    int S, int n, int m, int bs, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int subs = (bm + SUB - 1) / SUB, per_tile = subs * subs;
  const int64_t per_row = (int64_t)S * per_tile;
  int ti, tj;
  lower_tile((int)(blockIdx.x / per_row), ti, tj);
  const int rem = (int)(blockIdx.x % per_row);
  const int64_t s = rem / per_tile;
  const int sub = rem % per_tile;
  const int r0 = ti * bm + (sub / subs) * SUB;  // F rows = Y columns
  const int c0 = tj * bm + (sub % subs) * SUB;  // F columns
  syrk_tile<T, LoadInput, SUB, WARP_M, WARP_N>(
      Y + s * (int64_t)n * m, F + s * (int64_t)m * m, n, m,
      min(start_block[ti], n / bs) * bs, r0, c0, (ti + 1) * bm,
      (tj + 1) * bm, reinterpret_cast<T*>(smem_raw));
}

template <class T>
int launch(const void* Y, const void* start_block, void* F, int S, int n,
           int m, int bs, int bm, void* stream) {
  if (bm < 8 || bm % 8 || m % bm || bs < 1 || n % bs)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = syrk_smem_bytes<T, SUB>();
  cudaError_t err = dmma::set_smem(stepped_syrk_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nc = m / bm, subs = (bm + SUB - 1) / SUB;
  const int64_t blocks = (int64_t)nc * (nc + 1) / 2 * subs * subs * S;
  stepped_syrk_kernel<T><<<(unsigned)blocks, SYRK_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const T*)Y, (const int*)start_block, (T*)F, S, n, m, bs, bm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stepped_syrk_f64(const void* Y, const void* start_block,
                                void* F, int S, int n, int m, int bs, int bm,
                                void* stream) {
  return launch<double>(Y, start_block, F, S, n, m, bs, bm, stream);
}

extern "C" int stepped_syrk_f32(const void* Y, const void* start_block,
                                void* F, int S, int n, int m, int bs, int bm,
                                void* stream) {
  return launch<float>(Y, start_block, F, S, n, m, bs, bm, stream);
}
