// Device half of the stepped TRSM, shared by the dense and packed TRSM
// kernels (stepped_trsm.cu) and the fused TRSM->SYRK kernels
// (stepped_trsm_syrk.cu). Sm_90a, f64.
//
// solve_column_tile() runs the forward substitution of TN = 32 right-hand
// side columns of one subdomain, from its stripe's start block down:
//
//   Y[k] = Linv[k] (B[k] - sum_j L[k, j] Y[j]),  k >= start,
//
// where j walks the factor tiles of row k that the Factor accessor yields
// with j >= start (rows of Y above start are exactly zero, so skipping the
// tiles left of start is exact). Rows above start are written as zeros.
//
//   * DenseFactor: a row-major (S, n, n) factor; row k's tiles are
//     j in [start, k), leading dimension n.
//   * PackedFactor: the (S, n_blocks, bs, bs) value stack of a packed
//     factor with its CSR block index (rowptr, colidx) shared by all S;
//     row k's tiles are its stored slots t in [rowptr[k], rowptr[k+1] - 1)
//     (the diagonal slot, last in the row, is applied through Linv) with
//     colidx[t] >= start: slots are sorted by column, so those form one
//     contiguous run. Leading dimension bs. Absent blocks are never read.
//
// Products run on the FP64 tensor cores (dmma_f64.cuh): the block's
// (bs x 32) accumulator is split over 4 warps of 32 x 32, each holding
// 2 x 4 m16n8k8 fragments. Every product streams 16-deep chunks (a 128 x 16
// slice of a factor tile or of Linv[k], and the matching 16 x 32 rows of
// Y) through a 3-stage cp.async ring, so the next chunks' copies overlap
// the current chunk's products. The diagonal step stages the accumulator in
// shared memory as the right operand of Linv[k]. All operands are copied
// with cp.async.cg (L2): Y is this kernel's own output, and in the fused
// kernels other blocks read it in the same launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_f64.cuh"

namespace stepped {

constexpr int TN = 32;             // right-hand-side columns per block
constexpr int KC = 16;             // depth of one staged chunk
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int MAX_BS = 128;        // largest factor block
constexpr int THREADS = 128;       // 4 warps of 32 accumulator rows
constexpr int WROWS = MAX_BS / (THREADS / 32);  // rows per warp
constexpr int MI = WROWS / 8;      // 8-row fragment blocks per warp
constexpr int A_LD = KC + 4;       // factor / Linv chunk [MAX_BS][A_LD]
constexpr int B_LD = TN + 4;       // Y chunk [KC][B_LD]
constexpr int C_LD = TN + 4;       // diagonal step's right side [MAX_BS][C_LD]
constexpr int A_STAGE = MAX_BS * A_LD;
constexpr int STAGE = A_STAGE + KC * B_LD;
static_assert(A_LD % 16 == 4 && B_LD % 16 == 4 && C_LD % 16 == 4,
              "leading dimensions 4 (mod 16): conflict-free fragments");

constexpr size_t TRSM_SMEM_BYTES =
    sizeof(double) * (STAGES * STAGE + MAX_BS * C_LD);

// A factor accessor is bound to one subdomain with at(s, bs); tile(k, it, bs)
// is then the top-left element of row k's it-th tile, ld(bs) its leading
// dimension.
struct DenseFactor {
  const double* L;  // (S, n, n)
  int n;

  __device__ __forceinline__ DenseFactor at(int64_t s, int bs) const {
    return {L + s * (int64_t)n * n, n};
  }
  __device__ __forceinline__ int first(int k, int start) const { return start; }
  __device__ __forceinline__ int last(int k) const { return k; }
  __device__ __forceinline__ int col(int it) const { return it; }
  __device__ __forceinline__ int ld(int bs) const { return n; }
  __device__ __forceinline__ const double* tile(int k, int it, int bs) const {
    return L + (int64_t)k * bs * n + it * bs;
  }
};

struct PackedFactor {
  const double* values;  // (S, n_blocks, bs, bs)
  const int* rowptr;     // (nb + 1,)
  const int* colidx;     // (n_blocks,)
  int n_blocks;

  __device__ __forceinline__ PackedFactor at(int64_t s, int bs) const {
    return {values + s * n_blocks * (int64_t)bs * bs, rowptr, colidx,
            n_blocks};
  }

  // the first stored slot of row k with block column >= start
  __device__ __forceinline__ int first(int k, int start) const {
    int it = __ldg(rowptr + k);
    const int end = last(k);
    while (it < end && __ldg(colidx + it) < start) ++it;
    return it;
  }
  // the diagonal slot is the last of its row: stop before it
  __device__ __forceinline__ int last(int k) const {
    return __ldg(rowptr + k + 1) - 1;
  }
  __device__ __forceinline__ int col(int it) const { return __ldg(colidx + it); }
  __device__ __forceinline__ int ld(int bs) const { return bs; }
  __device__ __forceinline__ const double* tile(int k, int it, int bs) const {
    return values + (int64_t)it * bs * bs;
  }
};

// As[r][0..KC) = A[r][0..KC) for r < bs (A row-major, leading dim lda)
__device__ __forceinline__ void stage_a_chunk(double* As, const double* A,
                                              int lda, int bs) {
  for (int idx = threadIdx.x; idx < bs * (KC / 2); idx += THREADS) {
    const int r = idx / (KC / 2), q = 2 * (idx % (KC / 2));
    dmma::cp_async_cg(As + r * A_LD + q, A + r * lda + q);
  }
}

// Columns [col0, col0 + TN) of subdomain s. Linv (S, nb, bs, bs), B and Y
// (S, n, m) row-major; smem (16-byte aligned) holds TRSM_SMEM_BYTES. Every
// loop bound is uniform over the block, so the barriers inside are reached
// by all threads. Returns after this tile's last store of Y and a barrier.
template <class Factor>
__device__ __forceinline__ void solve_column_tile(
    const Factor& factor, const double* Linv, const double* B, double* Y,
    int64_t s, int col0, int start, int n, int m, int bs, double* smem) {
  const Factor fac = factor.at(s, bs);
  double* ring = smem;                 // STAGES x {A chunk, Y chunk}
  double* Cs = smem + STAGES * STAGE;  // [MAX_BS][C_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int wr0 = warp * WROWS;      // this warp's first accumulator row
  const bool active = wr0 < bs;      // warp-uniform
  const int nb = n / bs;
  const int cpt = bs / KC;           // chunks per factor tile
  const double* Bsub = B + s * (int64_t)n * m;
  const double* Linvs = Linv + s * (int64_t)nb * bs * bs;
  double* Ys = Y + s * (int64_t)n * m;

  // rows above the stripe's first block are structurally zero
  for (int idx = tid; idx < start * bs * (TN / 2); idx += THREADS) {
    const int r = idx / (TN / 2), c = 2 * (idx % (TN / 2));
    *reinterpret_cast<double2*>(Ys + (int64_t)r * m + col0 + c) =
        make_double2(0.0, 0.0);
  }

  for (int k = start; k < nb; ++k) {
    double acc[MI][TN / 8][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wr0 + 8 * i + g;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const double2 v =
            r < bs ? __ldg(reinterpret_cast<const double2*>(
                         Bsub + (int64_t)(k * bs + r) * m + col0 + 8 * j +
                         2 * t))
                   : make_double2(0.0, 0.0);
        acc[i][j][0] = v.x;
        acc[i][j][1] = v.y;
      }
    }

    // acc -= L[k, j] Y[j] over the factor tiles of row k with j >= start
    const int it0 = fac.first(k, start);
    const int lda = fac.ld(bs);
    dmma::pipeline<STAGES>(
        (fac.last(k) - it0) * cpt,
        [&](int c, int stage) {
          const int it = it0 + c / cpt, kc0 = (c % cpt) * KC;
          double* As = ring + stage * STAGE;
          stage_a_chunk(As, fac.tile(k, it, bs) + kc0, lda, bs);
          const double* Yj =
              Ys + (int64_t)(fac.col(it) * bs + kc0) * m + col0;
          for (int idx = tid; idx < KC * (TN / 2); idx += THREADS) {
            const int q = idx / (TN / 2), c2 = 2 * (idx % (TN / 2));
            dmma::cp_async_cg(As + A_STAGE + q * B_LD + c2,
                              Yj + (int64_t)q * m + c2);
          }
        },
        [&](int, int stage) {
          const double* As = ring + stage * STAGE;
          if (active)
            dmma::warp_mma<MI, TN / 8, KC, A_LD, 1, B_LD, true>(
                acc, As + wr0 * A_LD, As + A_STAGE);
        });

    // diagonal step: Y[k] = Linv[k] acc, acc staged as the right operand
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
        *reinterpret_cast<double2*>(Cs + (wr0 + 8 * i + g) * C_LD + 8 * j +
                                    2 * t) =
            make_double2(acc[i][j][0], acc[i][j][1]);
    double out[MI][TN / 8][2];
    dmma::zero(out);
    const double* Lkk_inv = Linvs + (int64_t)k * bs * bs;
    dmma::pipeline<STAGES>(
        cpt,
        [&](int c, int stage) {
          stage_a_chunk(ring + stage * STAGE, Lkk_inv + c * KC, bs, bs);
        },
        [&](int c, int stage) {
          if (active)
            dmma::warp_mma<MI, TN / 8, KC, A_LD, 1, C_LD, false>(
                out, ring + stage * STAGE + wr0 * A_LD, Cs + c * KC * C_LD);
        });
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wr0 + 8 * i + g;
      if (r < bs) {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
          *reinterpret_cast<double2*>(Ys + (int64_t)(k * bs + r) * m + col0 +
                                      8 * j + 2 * t) =
              make_double2(out[i][j][0], out[i][j][1]);
      }
    }
    // Y[k] is read back (through L2) by this block's later rows
    __syncthreads();
  }
}

}  // namespace stepped
