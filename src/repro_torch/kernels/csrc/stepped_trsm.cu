// Stepped TRSM for Hopper (sm_90a), f64: Y = L^{-1} B for a stepped B,
// batched over subdomains, against a dense or a packed factor.
//
// Replaces:
//   * stepped_trsm_f64: repro/kernels/stepped_trsm.py::stepped_trsm_pallas
//     (body _trsm_kernel), the TPU kernel of paper §3.2;
//   * stepped_trsm_packed_f64:
//     repro/kernels/stepped_trsm.py::stepped_trsm_packed_pallas (body
//     _trsm_packed_kernel), the same TRSM against a packed factor whose
//     inner loop walks only the stored blocks of each row.
//
// What bounds them: the f64 operations. The dense kernel's useful work is
// SteppedMeta.flops_trsm_rhs_split() per subdomain, times S (about 0.18
// TFLOP on feti-heat-2d's 64 subdomains of 4225 DOFs); the packed one does
// only the stored tiles' share of it (142 of 595 lower blocks there). Both
// run against the card's FP64 peak: 67 TFLOP/s through the FP64 tensor
// cores (DMMA), 34 TFLOP/s through plain FP64 FMA (NVIDIA H100 SXM data
// sheet). The factor they read is at most half of a padded (S, n, n) stack
// (~5 GB dense, ~1.2 GB packed), 0.4-1.5 ms at 3.35 TB/s.
//
// What the design does about it (the device code is stepped_trsm.cuh):
//   * Every block owns TN = 32 right-hand-side columns of one subdomain and
//     runs the whole forward substitution for them, starting at its
//     stripe's start block: the zero region above the column pivots is
//     never read (paper's RHS splitting). Pivots are sorted, so the
//     stripe's start is a valid lower bound for all of its columns.
//   * Narrow column tiles give S * m_pad / 32 independent blocks (768 at
//     full size) instead of the TPU grid's S * m_pad / 128 = 192, enough
//     to fill 132 SMs. The blocks of one subdomain run side by side and
//     read the same factor tiles, so the factor streams from L2.
//   * The diagonal step multiplies by the pre-inverted diagonal block, as
//     on the TPU, so all arithmetic is GEMM-shaped.
//   * One template over the factor accessor: the packed kernel is the dense
//     one with the tile walk replaced by the CSR walk over stored slots,
//     skipping slots left of the stripe's start (exact: Y is zero there).
//   * Plain f64 FMA, no DMMA, no TMA, no pipelining: a simple kernel that
//     is right. Those are the next steps toward the 67 TFLOP/s bound.
//
// Layout: row-major, Linv (S, nb, bs, bs), L (S, n, n) or values
// (S, n_blocks, bs, bs) with rowptr (nb + 1,) and colidx (n_blocks,)
// int32, B and Y (S, n, m), start_block (m / bm,) int32 shared by all
// subdomains. n and m are padded to bs and bm multiples; bs is a multiple
// of 32 up to 128, bm a multiple of 32. Rows above a stripe's start come
// out exactly zero.

#include "stepped_trsm.cuh"

namespace {

using namespace stepped;

template <class Factor>
__global__ void __launch_bounds__(THREADS)
stepped_trsm_kernel(Factor fac, const double* __restrict__ Linv,
                    const double* __restrict__ B,
                    const int* __restrict__ start_block,
                    double* __restrict__ Y, int n, int m, int bs, int bm) {
  extern __shared__ double smem[];
  const int col0 = blockIdx.x * TN;
  const int start = min(start_block[col0 / bm], n / bs);
  solve_column_tile(fac, Linv, B, Y, (int64_t)blockIdx.y, col0, start, n, m,
                    bs, smem);
}

template <class Factor>
int launch(Factor fac, const void* Linv, const void* B,
           const void* start_block, void* Y, int S, int n, int m, int bs,
           int bm, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stepped_trsm_kernel<Factor>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TRSM_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(m / TN, S);
  stepped_trsm_kernel<Factor>
      <<<grid, THREADS, TRSM_SMEM_BYTES, (cudaStream_t)stream>>>(
          fac, (const double*)Linv, (const double*)B,
          (const int*)start_block, (double*)Y, n, m, bs, bm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stepped_trsm_f64(const void* Linv, const void* L, const void* B,
                                const void* start_block, void* Y, int S, int n,
                                int m, int bs, int bm, void* stream) {
  return launch(DenseFactor{(const double*)L, n}, Linv, B, start_block, Y, S,
                n, m, bs, bm, stream);
}

extern "C" int stepped_trsm_packed_f64(const void* Linv, const void* values,
                                       const void* rowptr, const void* colidx,
                                       const void* B, const void* start_block,
                                       void* Y, int S, int n, int m, int bs,
                                       int bm, int n_blocks, void* stream) {
  return launch(PackedFactor{(const double*)values, (const int*)rowptr,
                             (const int*)colidx, n_blocks},
                Linv, B, start_block, Y, S, n, m, bs, bm, stream);
}
