// Stepped TRSM for Hopper (sm_90a), f64: Y = L^{-1} B for a stepped B,
// batched over subdomains.
//
// Replaces: repro/kernels/stepped_trsm.py::stepped_trsm_pallas (body
// _trsm_kernel), the TPU kernel of paper §3.2.
//
// What bounds it: the f64 operations. The useful work is
// SteppedMeta.flops_trsm_rhs_split() per subdomain, times S (about 0.3
// TFLOP on feti-heat-2d's 64 subdomains of 4225 DOFs), against the card's
// FP64 peak: 67 TFLOP/s through the FP64 tensor cores (DMMA), 34 TFLOP/s
// through plain FP64 FMA (NVIDIA H100 SXM data sheet). The factor it must
// read is about half of a padded (S, n, n) stack (~5 GB), ~1.5 ms at
// 3.35 TB/s, so the operations bound it by a wide margin.
//
// What the design does about it:
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
//     on the TPU, so all arithmetic is GEMM-shaped: each thread keeps a
//     4x4 register tile of the (bs x 32) accumulator and reads both
//     operands from shared memory (4 + 4 loads per 16 FMAs).
//   * Plain f64 FMA, no DMMA, no TMA, no pipelining: a simple kernel that
//     is right. Those are the next steps toward the 67 TFLOP/s bound.
//
// Layout: row-major, Linv (S, nb, bs, bs), L (S, n, n), B and Y (S, n, m),
// start_block (m / bm,) int32 shared by all subdomains. n and m are padded
// to bs and bm multiples; bs is a multiple of 32 up to 128, bm a multiple
// of 32. Rows above a stripe's start come out exactly zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 32;             // right-hand-side columns per block
constexpr int KC = 32;             // depth of one shared-memory chunk
constexpr int MAX_BS = 128;        // largest factor block
constexpr int THREADS = 256;       // 8 column groups x 32 row groups
constexpr int RPT = MAX_BS / 32;   // accumulator rows per thread
constexpr int CPT = TN / 8;        // accumulator columns per thread
constexpr int AS_LD = MAX_BS + 1;  // padded leading dim of a transposed A chunk

constexpr size_t SMEM_BYTES =
    sizeof(double) * (KC * AS_LD + KC * TN + MAX_BS * TN);

// As[q][r] = A[r][kc0 + q] for r < bs, q < KC (A row-major, leading dim lda)
__device__ __forceinline__ void load_a_chunk(double* As, const double* A,
                                             int64_t lda, int bs, int kc0,
                                             int tid) {
  for (int idx = tid; idx < bs * KC; idx += THREADS) {
    const int r = idx / KC, q = idx % KC;
    As[q * AS_LD + r] = A[(int64_t)r * lda + kc0 + q];
  }
}

// acc[i][c] += sign * sum_q As[q][row_i] * Bm[q * ldb + col_c]
template <bool SUBTRACT>
__device__ __forceinline__ void chunk_product(double (&acc)[RPT][CPT],
                                              const double* As,
                                              const double* Bm, int ldb,
                                              int bs, int tx, int ty) {
#pragma unroll 4
  for (int q = 0; q < KC; ++q) {
    double b[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) b[c] = Bm[q * ldb + tx + 8 * c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (ty + 32 * i < bs) {
        const double a = As[q * AS_LD + ty + 32 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (SUBTRACT) acc[i][c] -= a * b[c];
          else acc[i][c] += a * b[c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
stepped_trsm_kernel(const double* __restrict__ Linv,
                    const double* __restrict__ L,
                    const double* __restrict__ B,
                    const int* __restrict__ start_block,
                    double* __restrict__ Y, int n, int m, int bs, int bm) {
  extern __shared__ double smem[];
  double* As = smem;             // [KC][AS_LD] transposed chunk of L or Linv
  double* Bs = As + KC * AS_LD;  // [KC][TN]    chunk of solved Y rows
  double* Cs = Bs + KC * TN;     // [MAX_BS][TN] right side of the diagonal step

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int col0 = blockIdx.x * TN;
  const int64_t s = blockIdx.y;
  const int nb = n / bs;
  const int start = min(start_block[col0 / bm], nb);

  const double* Ls = L + s * (int64_t)n * n;
  const double* Bsub = B + s * (int64_t)n * m;
  const double* Linvs = Linv + s * (int64_t)nb * bs * bs;
  double* Ys = Y + s * (int64_t)n * m;

  // rows above the stripe's first block are structurally zero
  for (int idx = tid; idx < start * bs * TN; idx += THREADS) {
    const int r = idx / TN, c = idx % TN;
    Ys[(int64_t)r * m + col0 + c] = 0.0;
  }

  for (int k = start; k < nb; ++k) {
    double acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 32 * i;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[i][c] = r < bs
            ? Bsub[(int64_t)(k * bs + r) * m + col0 + tx + 8 * c] : 0.0;
    }

    // acc -= L[k, j] Y[j] over the factor tiles j in [start, k)
    for (int j = start; j < k; ++j) {
      const double* Lkj = Ls + (int64_t)(k * bs) * n + j * bs;
      for (int kc0 = 0; kc0 < bs; kc0 += KC) {
        load_a_chunk(As, Lkj, n, bs, kc0, tid);
        for (int idx = tid; idx < KC * TN; idx += THREADS) {
          const int q = idx / TN, c = idx % TN;
          Bs[q * TN + c] = Ys[(int64_t)(j * bs + kc0 + q) * m + col0 + c];
        }
        __syncthreads();
        chunk_product<true>(acc, As, Bs, TN, bs, tx, ty);
        __syncthreads();
      }
    }

    // diagonal step: Y[k] = Linv[k] acc
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 32 * i;
      if (r < bs) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) Cs[r * TN + tx + 8 * c] = acc[i][c];
      }
    }
    double out[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) out[i][c] = 0.0;
    const double* Lkk_inv = Linvs + (int64_t)k * bs * bs;
    for (int kc0 = 0; kc0 < bs; kc0 += KC) {
      load_a_chunk(As, Lkk_inv, bs, bs, kc0, tid);
      __syncthreads();
      chunk_product<false>(out, As, Cs + kc0 * TN, TN, bs, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 32 * i;
      if (r < bs) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          Ys[(int64_t)(k * bs + r) * m + col0 + tx + 8 * c] = out[i][c];
      }
    }
    // Y[k] is read back by this block's later rows
    __syncthreads();
  }
}

}  // namespace

extern "C" int stepped_trsm_f64(const void* Linv, const void* L, const void* B,
                                const void* start_block, void* Y, int S, int n,
                                int m, int bs, int bm, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stepped_trsm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(m / TN, S);
  stepped_trsm_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const double*)Linv, (const double*)L, (const double*)B,
      (const int*)start_block, (double*)Y, n, m, bs, bm);
  return (int)cudaGetLastError();
}
