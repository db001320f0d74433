// Device half of the stepped TRSM, shared by the dense and packed TRSM
// kernels (stepped_trsm.cu) and the fused TRSM->SYRK kernels
// (stepped_trsm_syrk.cu). Sm_90a; scalar type T = double or float.
//
// solve_column_tile<T, KC>() runs the forward substitution of TN = 32
// right-hand side columns of one subdomain, from its tile's start block
// down:
//
//   Y[k] = Linv[k] (B[k] - sum_j L[k, j] Y[j]),  k >= start,
//
// where j walks the factor tiles of row k that the Factor accessor yields
// with j >= start (rows of Y above start are exactly zero, so skipping the
// tiles left of start is exact). Rows above start are written as zeros.
// When bm < TN a tile spans several stripes; the caller passes the first
// one's start, the smallest (starts are non-decreasing). For a later
// stripe's columns the extra rows come out exact zeros (zero B rows, zero
// Y rows above), and their extra products add exact zeros, so the result
// is the stripe's own. Columns at or past m (the last tile when m is no
// multiple of TN) are neither read nor written.
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
// Products: f64 on the FP64 tensor cores (dmma_f64.cuh), f32 on FFMA
// accumulating in f32 (ffma_f32.cuh), both in one fragment layout. The
// block's (bs x 32) accumulator is split over 4 warps of 32 x 32; a warp
// whose rows all lie at or past bs idles (bs < 97), and rows past bs in an
// active warp are computed from stale shared memory and never stored. Every
// product streams KC-deep chunks (a bs x KC slice of a factor tile or of
// Linv[k], and the matching KC x 32 rows of Y) through a 3-stage cp.async
// ring, so the next chunks' copies overlap the current chunk's products.
// KC = 16 when it divides bs, else 8 (bs a multiple of 8: the small block
// sizes of the smoke configurations); the ring's layout is the same for
// both. The diagonal step stages the accumulator in shared memory as the
// right operand of Linv[k]. All operands are copied with cp.async.cg (L2):
// Y is this kernel's own output, and in the fused kernels other blocks read
// it in the same launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_f64.cuh"
#include "ffma_f32.cuh"

namespace stepped {

constexpr int TN = 32;             // right-hand-side columns per block
constexpr int KC_MAX = 16;         // deepest staged chunk
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int MAX_BS = 128;        // largest factor block
constexpr int MIN_BS = 8;          // bs and bm are multiples of it
constexpr int THREADS = 128;       // 4 warps of 32 accumulator rows
constexpr int WROWS = MAX_BS / (THREADS / 32);  // rows per warp
constexpr int MI = WROWS / 8;      // 8-row fragment blocks per warp
constexpr int A_LD = KC_MAX + 4;   // factor / Linv chunk [MAX_BS][A_LD]
constexpr int B_LD = TN + 4;       // Y chunk [KC_MAX][B_LD]
constexpr int C_LD = TN + 4;       // diagonal step's right side [MAX_BS][C_LD]
constexpr int A_STAGE = MAX_BS * A_LD;
constexpr int STAGE = A_STAGE + KC_MAX * B_LD;
static_assert(A_LD % 16 == 4 && B_LD % 16 == 4 && C_LD % 16 == 4,
              "leading dimensions 4 (mod 16): conflict-free fragments");

template <class T>
constexpr size_t trsm_smem_bytes() {
  return sizeof(T) * (STAGES * STAGE + MAX_BS * C_LD);
}

// A factor accessor is bound to one subdomain with at(s, bs); tile(k, it, bs)
// is then the top-left element of row k's it-th tile, ld(bs) its leading
// dimension.
template <class T>
struct DenseFactor {
  const T* L;  // (S, n, n)
  int n;

  __device__ __forceinline__ DenseFactor at(int64_t s, int bs) const {
    return {L + s * (int64_t)n * n, n};
  }
  __device__ __forceinline__ int first(int k, int start) const { return start; }
  __device__ __forceinline__ int last(int k) const { return k; }
  __device__ __forceinline__ int col(int it) const { return it; }
  __device__ __forceinline__ int ld(int bs) const { return n; }
  __device__ __forceinline__ const T* tile(int k, int it, int bs) const {
    return L + (int64_t)k * bs * n + it * bs;
  }
};

template <class T>
struct PackedFactor {
  const T* values;    // (S, n_blocks, bs, bs)
  const int* rowptr;  // (nb + 1,)
  const int* colidx;  // (n_blocks,)
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
  __device__ __forceinline__ const T* tile(int k, int it, int bs) const {
    return values + (int64_t)it * bs * bs;
  }
};

// As[r][0..KC) = A[r][0..KC) for r < bs (A row-major, leading dim lda)
template <class T, int KC>
__device__ __forceinline__ void stage_a_chunk(T* As, const T* A, int lda,
                                              int bs) {
  constexpr int V = tile::VEC<T>;
  static_assert(KC % V == 0, "whole 16-byte copies");
  for (int idx = threadIdx.x; idx < bs * (KC / V); idx += THREADS) {
    const int r = idx / (KC / V), q = V * (idx % (KC / V));
    dmma::cp_async_cg(As + r * A_LD + q, A + r * lda + q);
  }
}

// Columns [col0, col0 + TN) of subdomain s, clipped to m. Linv
// (S, nb, bs, bs), B and Y (S, n, m) row-major; smem (16-byte aligned) holds
// trsm_smem_bytes<T>(). Every loop bound is uniform over the block, so the
// barriers inside are reached by all threads. Returns after this tile's
// last store of Y and a barrier.
template <class T, int KC, class Factor>
__device__ __forceinline__ void solve_column_tile(
    const Factor& factor, const T* Linv, const T* B, T* Y, int64_t s,
    int col0, int start, int n, int m, int bs, T* smem) {
  using P = typename tile::Pair<T>::type;
  constexpr int V = tile::VEC<T>;
  const Factor fac = factor.at(s, bs);
  T* ring = smem;                 // STAGES x {A chunk, Y chunk}
  T* Cs = smem + STAGES * STAGE;  // [MAX_BS][C_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int wr0 = warp * WROWS;      // this warp's first accumulator row
  const bool active = wr0 < bs;      // warp-uniform
  const int nb = n / bs;
  const int cpt = bs / KC;           // chunks per factor tile
  const int width = min(TN, m - col0);  // a multiple of MIN_BS
  const T* Bsub = B + s * (int64_t)n * m;
  const T* Linvs = Linv + s * (int64_t)nb * bs * bs;
  T* Ys = Y + s * (int64_t)n * m;

  // rows above the tile's first block are structurally zero
  for (int idx = tid; idx < start * bs * (TN / 2); idx += THREADS) {
    const int r = idx / (TN / 2), c = 2 * (idx % (TN / 2));
    if (c < width)
      *reinterpret_cast<P*>(Ys + (int64_t)r * m + col0 + c) =
          tile::pair<T>(0, 0);
  }

  for (int k = start; k < nb; ++k) {
    T acc[MI][TN / 8][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wr0 + 8 * i + g;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const P v = r < bs && 8 * j < width
                        ? __ldg(reinterpret_cast<const P*>(
                              Bsub + (int64_t)(k * bs + r) * m + col0 +
                              8 * j + 2 * t))
                        : tile::pair<T>(0, 0);
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
          T* As = ring + stage * STAGE;
          stage_a_chunk<T, KC>(As, fac.tile(k, it, bs) + kc0, lda, bs);
          const T* Yj = Ys + (int64_t)(fac.col(it) * bs + kc0) * m + col0;
          for (int idx = tid; idx < KC * (TN / V); idx += THREADS) {
            const int q = idx / (TN / V), cv = V * (idx % (TN / V));
            const bool in = cv < width;
            dmma::cp_async_cg(As + A_STAGE + q * B_LD + cv,
                              in ? Yj + (int64_t)q * m + cv : Yj, in);
          }
        },
        [&](int, int stage) {
          const T* As = ring + stage * STAGE;
          if (active)
            tile::mma<MI, TN / 8, KC, A_LD, 1, B_LD, true>(
                acc, As + wr0 * A_LD, As + A_STAGE);
        });

    // diagonal step: Y[k] = Linv[k] acc, acc staged as the right operand
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
        *reinterpret_cast<P*>(Cs + (wr0 + 8 * i + g) * C_LD + 8 * j + 2 * t) =
            tile::pair<T>(acc[i][j][0], acc[i][j][1]);
    T out[MI][TN / 8][2];
    tile::zero(out);
    const T* Lkk_inv = Linvs + (int64_t)k * bs * bs;
    dmma::pipeline<STAGES>(
        cpt,
        [&](int c, int stage) {
          stage_a_chunk<T, KC>(ring + stage * STAGE, Lkk_inv + c * KC, bs,
                               bs);
        },
        [&](int c, int stage) {
          if (active)
            tile::mma<MI, TN / 8, KC, A_LD, 1, C_LD, false>(
                out, ring + stage * STAGE + wr0 * A_LD, Cs + c * KC * C_LD);
        });
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wr0 + 8 * i + g;
      if (r < bs) {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
          if (8 * j < width)
            *reinterpret_cast<P*>(Ys + (int64_t)(k * bs + r) * m + col0 +
                                  8 * j + 2 * t) =
                tile::pair<T>(out[i][j][0], out[i][j][1]);
      }
    }
    // Y[k] is read back (through L2) by this block's later rows
    __syncthreads();
  }
}

}  // namespace stepped
