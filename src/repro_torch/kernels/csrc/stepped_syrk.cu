// Stepped SYRK for Hopper (sm_90a), f64 and f32: the lower block triangle
// of F = Y^T Y for a stepped Y, batched over subdomains.
//
// Replaces: repro/kernels/stepped_syrk.py::stepped_syrk_pallas (body
// _syrk_kernel), the TPU kernel of paper §3.3: stepped_syrk_f64 at f64,
// stepped_syrk_f32 at f32 and for bf16 storage, whose prep runs at f32
// (the TPU kernel accumulates sub-f64 inputs in f32; so does this one,
// 3xTF32 on the tensor cores with round-to-nearest f32 adds between k8
// steps).
//
// What bounds it (f64): the useful work is
// SteppedMeta.flops_syrk_output_split() per subdomain, times S (about 0.011
// TFLOP on feti-heat-2d's 64 subdomains), 0.17 ms at the FP64 tensor
// cores' 67 TFLOP/s (NVIDIA H100 SXM data sheet, 700 W; plain FP64 FMA
// peaks at half that). It must also read Y below each stripe's start once
// (~0.5 GB at full size, ~0.16 ms at 3.35 TB/s), so operations and bytes
// bound it about equally; the caller's TRSM does over ten times its work.
// f32: the operations at 3xTF32's rate (three TF32 tensor-core products at
// 494.7 TFLOP/s each) or half the f64 bytes.
//
// What the design does about it (the device code is stepped_syrk.cuh):
//   * A block computes one 128 x 128 region of F on 8 warps of 64 x 32
//     (mma.sync m16n8k8: DMMA at f64, 3xTF32 HMMA at f32), streaming
//     16-row chunks (32 at f32) of the two Y column panels through a
//     3-stage cp.async ring. A warp loads 8 + 4 fragments for every 16 products, so shared
//     memory keeps up with the tensor cores; the price is registers (one
//     block a SM).
//   * Regions follow groups of stripes, not single bm x bm tiles: a group
//     is G = 128 / bm stripes when bm < 128 (the largest whole number of
//     stripes in 128 columns), else one stripe cut into 128 x 128
//     sub-tiles. Only lower groups (group row >= group column) are
//     launched, the last one clipped at m. One block a bm x bm tile would
//     keep (bm / 128)^2 of its products: at feti-heat-2d's bm = 16
//     (m = 272, S = 64) 9,792 blocks each keeping 1/64 of its work, where
//     384 blocks cover the same groups.
//   * Paper's k-dimension reduction: a region reduces from its first row
//     stripe's start, the smallest of its stripes' (starts are
//     non-decreasing). Staged elements above their own column's stripe
//     start are zero-filled, so each entry sums exactly the TPU kernel's
//     terms (k >= the start of its row's stripe) for any Y, and a warp
//     whose rows' stripes all start past a chunk skips that chunk's
//     products. Entries of a stripe pair (i, j > i) inside a diagonal
//     group are never stored and keep the zeros the wrapper allocated,
//     which the mirror step relies on.
//   * Blocks are numbered group-major, so the groups of the first stripes,
//     which reduce over the most rows, start first; the sub-tiles of one
//     group are neighbours and share their panels in L2.
//
// Layout: row-major, Y (S, n, m), F (S, m, m), start_block (m / bm,) int32
// non-decreasing (as the stepped metadata makes it), every array 16-byte
// aligned (the wrapper checks). n is padded to a bs multiple (any bs: the
// last chunk is clipped to n), m to a bm multiple, bm a multiple of 8.

#include "stepped_syrk.cuh"

namespace {

using namespace stepped;

// 128 x 128 regions on 8 warps of 64 x 32 measured faster than 64 x 64
// regions on 8 warps of 32 x 16 (PERF.md)
constexpr int SUB = 128, WARP_M = 64, WARP_N = 32;

template <class T>
__global__ void __launch_bounds__(SYRK_THREADS)
stepped_syrk_kernel(const T* __restrict__ Y,
                    const int* __restrict__ start_block, T* __restrict__ F,
                    int S, int n, int m, int bs, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int width = group_stripes<SUB>(bm) * bm;
  const int subs = (width + SUB - 1) / SUB, per_group = subs * subs;
  const int64_t per_row = (int64_t)S * per_group;
  int gi, gj;
  lower_tile((int)(blockIdx.x / per_row), gi, gj);
  const int rem = (int)(blockIdx.x % per_row);
  const int64_t s = rem / per_group;
  const int sub = rem % per_group;
  const int r0 = gi * width + (sub / subs) * SUB;  // F rows = Y columns
  const int c0 = gj * width + (sub % subs) * SUB;  // F columns
  syrk_tile<T, LoadInput, SUB, WARP_M, WARP_N>(
      Y + s * (int64_t)n * m, F + s * (int64_t)m * m, n, m,
      Stripes{start_block, bs, bm, n / bs}, r0, c0,
      min((gi + 1) * width, m), min((gj + 1) * width, m),
      reinterpret_cast<T*>(smem_raw));
}

template <class T>
int launch(const void* Y, const void* start_block, void* F, int S, int n,
           int m, int bs, int bm, void* stream) {
  if (bm < 8 || bm % 8 || m % bm || bs < 1 || n % bs)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = syrk_smem_bytes<T, SUB>();
  cudaError_t err = dmma::set_smem(stepped_syrk_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int g = group_stripes<SUB>(bm), width = g * bm;
  const int groups = (m / bm + g - 1) / g, subs = (width + SUB - 1) / SUB;
  const int64_t blocks =
      (int64_t)groups * (groups + 1) / 2 * subs * subs * S;
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
