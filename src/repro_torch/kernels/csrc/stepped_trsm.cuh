// Device half of the stepped TRSM, shared by the dense and packed TRSM
// kernels (stepped_trsm.cu) and the fused TRSM->SYRK kernels
// (stepped_trsm_syrk.cu). Sm_90a; scalar type T = double or float.
//
// solve_tile<T, KC, PASSES>() runs the forward substitution of TN = 32 right-hand
// side columns of one subdomain, from its tile's start block down:
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
// Products: f64 on the FP64 tensor cores (dmma_f64.cuh), f32 on the TF32
// tensor cores at f32 accuracy, three TF32 products each (tf32x3_f32.cuh),
// both in the m16n8k8 fragment layout. Every product streams chunks of
// the factor (and the matching rows of Y) through a cp.async ring (3
// stages, 2 in the f32 row-split core), so the next chunks' copies overlap
// the current chunk's products; all
// operands are copied with cp.async.cg (L2): Y is this kernel's own
// output, and in the fused kernels other blocks read it in the same
// launch. Three cores, one per shape of the work:
//   * the row-split core (bs >= 24), solve_column_tile(): a pass of ROWS
//     = 128 accumulator rows (x 32 columns) is split over 4 warps of
//     32 x 32; a warp whose rows all lie at or past the pass's last row
//     idles (bs < 97), and rows past it in an active warp are computed
//     from stale shared memory and never stored. A block of bs > 128 rows
//     (up to MAX_BS = 256) takes two passes over the same 4 warps: each
//     pass first subtracts every earlier block's contribution from its
//     rows, and only then does the diagonal step apply the whole inverse
//     block, Y_top = Linv[:128, :128] r_top and Y_bot = Linv[128:, :] r
//     (Linv[k] is lower triangular, so the top pass reads Cs rows below
//     128 never). Chunks are KC deep: ROW_KC<T> (16 at f64, 32 at f32)
//     where that divides bs, else 16 or 8; the ring's layout is the same
//     for all. The diagonal step stages both passes' sums in shared
//     memory (Cs, PASSES x 128 rows) as the right operand of Linv[k]. The
//     pass count is a template argument (row_passes(bs)), so the one-pass
//     instances that serve bs <= 128 are the single-pass core as it was;
//   * the panel core (dense factor, bs <= 16), solve_column_tile_panel():
//     64 rows of the factor a pass, 16 a warp, so Y is read once a panel,
//     not once a factor row, and every warp works; the panel's diagonal
//     is solved in shared memory, each warp its own 8 columns;
//   * the k-split core (packed factor, bs <= 16),
//     solve_column_tile_ksplit(): one factor row at a time, its stored
//     tiles 64 / bs to a chunk, each warp every fourth k8 step into its own
//     partial sum (the rows of a panel would walk different slots).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dmma_f64.cuh"
#include "tf32x3_f32.cuh"

namespace stepped {

constexpr int TN = 32;             // right-hand-side columns per block
constexpr int STAGES = 3;          // cp.async ring depth (row core: ROW_STAGES)
constexpr int ROWS = 128;          // row core's accumulator rows a pass
constexpr int MAX_BS = 2 * ROWS;   // largest factor block: two passes
constexpr int MIN_BS = 8;          // bs and bm are multiples of it
constexpr int THREADS = 128;       // 4 warps of 32 accumulator rows
constexpr int WROWS = ROWS / (THREADS / 32);  // rows per warp
constexpr int MI = WROWS / 8;      // 8-row fragment blocks per warp
constexpr int WARPS = THREADS / 32;
// The row-split core's deepest chunk and ring: 16 deep in 3 stages at f64;
// at f32 32 deep (half the barriers a row) in 2 stages (68 KB of shared
// memory: three blocks a SM, which measured faster than 3 stages in two)
template <class T>
constexpr int ROW_KC = sizeof(T) == 8 ? 16 : 32;
template <class T>
constexpr int ROW_STAGES = sizeof(T) == 8 ? 3 : 2;
// factor / Linv chunk [ROWS][ROW_LD]: 4 (mod 16) doubles, 4 (mod 8) words
template <class T>
constexpr int ROW_LD = ROW_KC<T> + 4;
// Y chunk [ROW_KC][Y_LD] and the diagonal step's right side [ROWS][Y_LD] a
// pass:
// 4 (mod 16) doubles, 8 (mod 32) words at f32 (tf32x3_f32.cuh)
template <class T>
constexpr int Y_LD = sizeof(T) == 8 ? TN + 4 : TN + 8;
template <class T>
constexpr int A_STAGE = ROWS * ROW_LD<T>;
template <class T>
constexpr int STAGE = A_STAGE<T> + ROW_KC<T> * Y_LD<T>;
static_assert(ROW_LD<double> % 16 == 4 && ROW_LD<float> % 8 == 4 &&
                  Y_LD<double> % 16 == 4 && Y_LD<float> % 32 == 8,
              "conflict-free fragments at f64 and f32");

// the row core's passes over a bs-row block (1 up to bs = 128, else 2)
constexpr int row_passes(int bs) {
  return (bs + ROWS - 1) / ROWS;
}

// the ring and the diagonal step's right side, ROWS rows a pass: in one
// pass 112 KB at f64 (two blocks a SM) and 68 KB at f32; in two 149 KB at
// f64 (one block a SM) and 88 KB at f32 (two)
template <class T, int PASSES>
constexpr size_t trsm_smem_bytes() {
  return sizeof(T) * (ROW_STAGES<T> * STAGE<T> + PASSES * ROWS * Y_LD<T>);
}

// Small blocks (bs <= SMALL_MAX_BS) run the small-block cores, which the
// template argument KC = SMALL selects (any other KC is the row-split
// core's chunk depth): the panel core on a dense factor, the k-split core
// on a packed one.
constexpr int SMALL_MAX_BS = 16;
constexpr int SMALL = 0;
constexpr int LINV_LD = 20;  // Linv blocks [rows][LINV_LD]: 4 (mod 16)
static_assert(TN == 8 * WARPS, "a diagonal-step column tile a warp");

// The k-split core: KSPLIT_KC-deep chunks spanning several stored tiles of
// one factor row, SROWS accumulator rows in every warp.
constexpr int KSPLIT_KC = 64;
constexpr int SROWS = 16;              // one m16 fragment row block
constexpr int S_A_LD = KSPLIT_KC + 4;  // factor chunk [SROWS][S_A_LD]
template <class T>
constexpr int S_STAGE = SROWS * S_A_LD + KSPLIT_KC * Y_LD<T>;
static_assert(S_A_LD % 16 == 4, "conflict-free fragments at f64 and f32");
static_assert(KSPLIT_KC % (8 * WARPS) == 0, "every warp a k8 step a chunk");

// the ring, the warps' partial sums [WARPS][SROWS][Y_LD] and Linv[k]
// [SROWS][LINV_LD]
template <class T>
constexpr size_t ksplit_smem_bytes() {
  return sizeof(T) * (STAGES * S_STAGE<T> + WARPS * SROWS * Y_LD<T> +
                      SROWS * LINV_LD);
}

// The panel core: PROWS panel rows (PROWS / bs factor rows) a pass, 16 a
// warp, PKC-deep chunks of the panel's row block of L (64 at f32: 93 KB,
// two blocks a SM; 32 at f64: 101 KB)
constexpr int PROWS = 16 * WARPS;
template <class T>
constexpr int PKC = sizeof(T) == 8 ? 32 : 64;
template <class T>
constexpr int P_LD = PKC<T> + 4;  // factor chunk [PROWS][P_LD]
template <class T>
constexpr int P_STAGE = PROWS * P_LD<T> + PKC<T> * Y_LD<T>;
// after the chunks the ring holds the diagonal panel [PROWS + 8][D_LD] and
// its Linv blocks [PROWS + 8][LINV_LD] (8 rows of slack: an m16 fragment of
// the last 8-row block reads past the panel)
constexpr int D_LD = PROWS + 4;
static_assert(P_LD<float> % 8 == 4 && P_LD<double> % 16 == 4 &&
                  D_LD % 16 == 4,
              "conflict-free fragments at f64 and f32");
static_assert((PROWS + 8) * (D_LD + LINV_LD) <= STAGES * P_STAGE<float> &&
                  (PROWS + 8) * (D_LD + LINV_LD) <= STAGES * P_STAGE<double>,
              "the diagonal panel fits in the ring");

// the ring and the panel's sums, then its Y [PROWS][Y_LD]
template <class T>
constexpr size_t panel_smem_bytes() {
  return sizeof(T) * (STAGES * P_STAGE<T> + PROWS * Y_LD<T>);
}

// A factor accessor is bound to one subdomain with at(s, bs); tile(k, it, bs)
// is then the top-left element of row k's it-th tile, ld(bs) its leading
// dimension.
template <class T>
struct DenseFactor {
  static constexpr bool contiguous = true;  // row k's tiles side by side
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
  static constexpr bool contiguous = false;
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

// As[r][0..KC) = A[r][0..KC) for r < rows (A row-major, leading dim lda)
template <class T, int KC>
__device__ __forceinline__ void stage_a_chunk(T* As, const T* A, int lda,
                                              int rows) {
  constexpr int V = tile::VEC<T>;
  static_assert(KC > 0 && KC % V == 0 && ROW_KC<T> % KC == 0,
                "whole 16-byte copies into a ROW_KC-deep ring");
  for (int idx = threadIdx.x; idx < rows * (KC / V); idx += THREADS) {
    const int r = idx / (KC / V), q = V * (idx % (KC / V));
    dmma::cp_async_cg(As + r * ROW_LD<T> + q, A + r * lda + q);
  }
}

// rows [0, rows) of Y's columns [col0, col0 + width): those above a tile's
// first block are structurally zero
template <class T>
__device__ __forceinline__ void zero_rows(T* Ys, int rows, int m, int col0,
                                          int width) {
  using P = typename tile::Pair<T>::type;
  for (int idx = threadIdx.x; idx < rows * (TN / 2); idx += THREADS) {
    const int r = idx / (TN / 2), c = 2 * (idx % (TN / 2));
    if (c < width)
      *reinterpret_cast<P*>(Ys + (int64_t)r * m + col0 + c) =
          tile::pair<T>(0, 0);
  }
}

// Columns [col0, col0 + TN) of subdomain s, clipped to m. Linv
// (S, nb, bs, bs), B and Y (S, n, m) row-major, PASSES == row_passes(bs);
// smem (16-byte aligned) holds trsm_smem_bytes<T, PASSES>(). Every loop
// bound is uniform over the block, so the barriers inside are reached by
// all threads. Returns after this tile's last store of Y and a barrier.
template <class T, int KC, int PASSES, class Factor>
__device__ __forceinline__ void solve_column_tile(
    const Factor& factor, const T* Linv, const T* B, T* Y, int64_t s,
    int col0, int start, int n, int m, int bs, T* smem) {
  using P = typename tile::Pair<T>::type;
  constexpr int V = tile::VEC<T>;
  constexpr int STAGE = stepped::STAGE<T>;
  constexpr int RING = ROW_STAGES<T>;
  constexpr int A_STAGE = stepped::A_STAGE<T>;
  constexpr int A_LD = ROW_LD<T>;
  constexpr int B_LD = Y_LD<T>, C_LD = Y_LD<T>;
  const Factor fac = factor.at(s, bs);
  T* ring = smem;                 // RING x {A chunk, Y chunk}
  T* Cs = smem + RING * STAGE;    // [PASSES * ROWS][C_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int wr0 = warp * WROWS;      // this warp's first row of a pass
  const int nb = n / bs;
  const int cpt = bs / KC;           // chunks per factor tile
  const int width = min(TN, m - col0);  // a multiple of MIN_BS
  const T* Bsub = B + s * (int64_t)n * m;
  const T* Linvs = Linv + s * (int64_t)nb * bs * bs;
  T* Ys = Y + s * (int64_t)n * m;

  zero_rows(Ys, start * bs, m, col0, width);

  for (int k = start; k < nb; ++k) {
    // each pass: its rows of B[k] - sum_j L[k, j] Y[j], over the factor
    // tiles of row k with j >= start, staged in Cs (unrolled: at PASSES = 1
    // no pass arithmetic is left)
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int pr0 = p * ROWS;  // the pass's first row of k
      // its rows, a multiple of MIN_BS
      const int rows = PASSES == 1 ? bs : min(ROWS, bs - pr0);
      const bool active = wr0 < rows;         // warp-uniform
      T acc[MI][TN / 8][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wr0 + 8 * i + g;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const P v = r < rows && 8 * j < width
                          ? __ldg(reinterpret_cast<const P*>(
                                Bsub + (int64_t)(k * bs + pr0 + r) * m +
                                col0 + 8 * j + 2 * t))
                          : tile::pair<T>(0, 0);
          acc[i][j][0] = v.x;
          acc[i][j][1] = v.y;
        }
      }

      const int it0 = fac.first(k, start);
      const int lda = fac.ld(bs);
      dmma::pipeline<RING>(
          (fac.last(k) - it0) * cpt,
          [&](int c, int stage) {
            const int it = it0 + c / cpt, kc0 = (c % cpt) * KC;
            T* As = ring + stage * STAGE;
            stage_a_chunk<T, KC>(
                As, fac.tile(k, it, bs) + (int64_t)pr0 * lda + kc0, lda,
                rows);
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
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
          *reinterpret_cast<P*>(Cs + (pr0 + wr0 + 8 * i + g) * C_LD + 8 * j +
                                2 * t) =
              tile::pair<T>(acc[i][j][0], acc[i][j][1]);
    }

    // diagonal step, a pass at a time: Y[k] = Linv[k] Cs. Linv[k] is lower
    // triangular, so a pass's rows take Cs rows [0, pr0 + rows) only (a
    // multiple of KC: 128 or bs)
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int pr0 = p * ROWS;
      const int rows = PASSES == 1 ? bs : min(ROWS, bs - pr0);
      const bool active = wr0 < rows;
      T out[MI][TN / 8][2];
      tile::zero(out);
      const T* Lkk_inv = Linvs + ((int64_t)k * bs + pr0) * bs;
      dmma::pipeline<RING>(
          PASSES == 1 ? cpt : (pr0 + rows) / KC,
          [&](int c, int stage) {
            stage_a_chunk<T, KC>(ring + stage * STAGE, Lkk_inv + c * KC, bs,
                                 rows);
          },
          [&](int c, int stage) {
            if (active)
              tile::mma<MI, TN / 8, KC, A_LD, 1, C_LD, false>(
                  out, ring + stage * STAGE + wr0 * A_LD,
                  Cs + c * KC * C_LD);
          });
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wr0 + 8 * i + g;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < TN / 8; ++j)
            if (8 * j < width)
              *reinterpret_cast<P*>(Ys + (int64_t)(k * bs + pr0 + r) * m +
                                    col0 + 8 * j + 2 * t) =
                  tile::pair<T>(out[i][j][0], out[i][j][1]);
        }
      }
    }
    // Y[k] is read back (through L2) by this block's later rows
    __syncthreads();
  }
}

// The same contract as solve_column_tile() for bs <= SMALL_MAX_BS (8 or
// 16), with every warp at work. Row k's factor tiles are staged KSPLIT_KC /
// bs at a time (dense: side by side in L's row panel; packed: consecutive
// stored slots), one KSPLIT_KC-deep chunk each with its Y rows, and each
// warp multiplies every WARPS-th k8 step of a chunk into its own SROWS x TN
// partial sum (k-split); warp 0's starts from B[k]. The partials meet in
// shared memory, and in the diagonal step warp w takes columns
// [8w, 8w + 8) of Y[k] = Linv[k] (sum of the partials), Linv[k] copied in
// beside the chunks. Rows past bs (bs = 8) are computed from stale shared
// memory and never read or stored.
template <class T, class Factor>
__device__ __forceinline__ void solve_column_tile_ksplit(
    const Factor& factor, const T* Linv, const T* B, T* Y, int64_t s,
    int col0, int start, int n, int m, int bs, T* smem) {
  using P = typename tile::Pair<T>::type;
  constexpr int V = tile::VEC<T>;
  constexpr int LD = Y_LD<T>;
  constexpr int A_ST = SROWS * S_A_LD;
  constexpr int ST = S_STAGE<T>;
  constexpr int PART = SROWS * LD;
  constexpr int NJ = TN / 8;
  const Factor fac = factor.at(s, bs);
  T* ring = smem;                  // STAGES x {factor chunk, Y chunk}
  T* part = smem + STAGES * ST;    // [WARPS][SROWS][LD]
  T* Ls = part + WARPS * PART;     // [SROWS][LINV_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int nb = n / bs;
  const int per = KSPLIT_KC / bs;       // factor tiles per chunk
  const int width = min(TN, m - col0);  // a multiple of MIN_BS
  const int cw = 8 * warp;              // this warp's diagonal-step columns
  const T* Bsub = B + s * (int64_t)n * m;
  const T* Linvs = Linv + s * (int64_t)nb * bs * bs;
  T* Ys = Y + s * (int64_t)n * m;

  zero_rows(Ys, start * bs, m, col0, width);

  for (int k = start; k < nb; ++k) {
    const T* Lkk_inv = Linvs + (int64_t)k * bs * bs;
    for (int idx = tid; idx < bs * (bs / V); idx += THREADS) {
      const int r = idx / (bs / V), q = V * (idx % (bs / V));
      dmma::cp_async_cg(Ls + r * LINV_LD + q, Lkk_inv + r * bs + q);
    }
    T acc[2][NJ][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 8 * i + g;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const P v = warp == 0 && r < bs && 8 * j < width
                        ? __ldg(reinterpret_cast<const P*>(
                              Bsub + (int64_t)(k * bs + r) * m + col0 +
                              8 * j + 2 * t))
                        : tile::pair<T>(0, 0);
        acc[i][j][0] = v.x;
        acc[i][j][1] = v.y;
      }
    }

    // acc -= L[k, j] Y[j], the row's tiles KSPLIT_KC / bs to a chunk
    const int it0 = fac.first(k, start);
    const int tiles = fac.last(k) - it0;
    const int lda = fac.ld(bs);
    dmma::pipeline<STAGES>(
        (tiles + per - 1) / per,
        [&](int c, int stage) {
          T* As = ring + stage * ST;
          const int first = it0 + c * per;
          const int cnt = min(per, tiles - c * per);
          const int tile_copies = bs * (bs / V);
          for (int idx = tid; idx < cnt * tile_copies; idx += THREADS) {
            const int p = idx / tile_copies, rem = idx % tile_copies;
            const int r = rem / (bs / V), q = V * (rem % (bs / V));
            dmma::cp_async_cg(As + r * S_A_LD + p * bs + q,
                              fac.tile(k, first + p, bs) + r * lda + q);
          }
          for (int idx = tid; idx < cnt * bs * (TN / V); idx += THREADS) {
            const int row = idx / (TN / V), cv = V * (idx % (TN / V));
            const bool in = cv < width;
            const T* Yj = Ys + (int64_t)(fac.col(first + row / bs) * bs +
                                         row % bs) * m + col0;
            dmma::cp_async_cg(As + A_ST + row * LD + cv, in ? Yj + cv : Yj,
                              in);
          }
        },
        [&](int c, int stage) {
          const T* As = ring + stage * ST;
          const int steps = min(per, tiles - c * per) * bs / 8;
#pragma unroll
          for (int i = 0; i < KSPLIT_KC / 8 / WARPS; ++i) {
            const int kk = warp + WARPS * i;  // warp-uniform
            if (kk < steps)
              tile::mma<2, NJ, 8, S_A_LD, 1, LD, true>(
                  acc, As + 8 * kk, As + A_ST + 8 * kk * LD);
          }
        });

    // diagonal step: Y[k] = Linv[k] (sum of the warps' partials)
    T* mine = part + warp * PART;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<P*>(mine + (8 * i + g) * LD + 8 * j + 2 * t) =
            tile::pair<T>(acc[i][j][0], acc[i][j][1]);
    __syncthreads();
    T out[2][2] = {};
    for (int kk = 0; kk < bs / 8; ++kk) {
      T a[4], b[2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[q] = Ls[(8 * (q & 1) + g) * LINV_LD + 8 * kk + t + 4 * (q >> 1)];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const T* x = part + (8 * kk + t + 4 * q) * LD + cw + g;
        b[q] = ((x[0] + x[PART]) + x[2 * PART]) + x[3 * PART];
      }
      tile::frag_mma(out[0], out[1], a, b);
    }
    if (cw < width) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 8 * i + g;
        if (r < bs)
          *reinterpret_cast<P*>(Ys + (int64_t)(k * bs + r) * m + col0 + cw +
                                2 * t) = tile::pair<T>(out[i][0], out[i][1]);
      }
    }
    // Y[k] is read back (through L2) by this block's later rows; Ls and
    // the partials are rewritten
    __syncthreads();
  }
}

// The same contract as solve_column_tile() for a dense factor and bs <=
// SMALL_MAX_BS (8 or 16), with every warp at work and Y read once a panel,
// not once a factor row. A panel is PROWS rows of the factor (PROWS / bs
// factor rows), warp w's accumulator rows [16w, 16w + 16):
//   * acc = B[panel] - L[panel, start:k0] Y[start:k0], the panel's row
//     block of L streamed in PKC-deep chunks (dense: one contiguous range
//     of columns) with the matching rows of Y, which every warp shares;
//   * the diagonal panel (its lower blocks of L, and the Linv blocks) is
//     then copied into the ring, and each warp solves its own columns
//     [8w, 8w + 8) of the panel factor row by factor row, in shared memory:
//     Y_b = Linv_b (acc_b - L[b, :b] Y[:b]), with only warp syncs.
// Rows past the last factor row, and the rows of an m16 fragment past its
// 8-row block (bs = 8), are computed from stale shared memory and never
// read or stored.
template <class T>
__device__ __forceinline__ void solve_column_tile_panel(
    const DenseFactor<T>& factor, const T* Linv, const T* B, T* Y, int64_t s,
    int col0, int start, int n, int m, int bs, T* smem) {
  using P = typename tile::Pair<T>::type;
  constexpr int V = tile::VEC<T>;
  constexpr int LD = Y_LD<T>;
  constexpr int KC = PKC<T>, ALD = P_LD<T>;
  constexpr int A_ST = PROWS * ALD;
  constexpr int ST = P_STAGE<T>;
  constexpr int NJ = TN / 8;
  const DenseFactor<T> fac = factor.at(s, bs);
  T* ring = smem;                 // STAGES x {factor chunk, Y chunk}
  T* Cs = smem + STAGES * ST;     // [PROWS][LD]: the panel's sums, then Y
  T* Ds = ring;                   // diagonal panel [PROWS + 8][D_LD]
  T* Is = ring + (PROWS + 8) * D_LD;  // its Linv blocks [PROWS + 8][LINV_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int nb = n / bs;
  const int G = PROWS / bs;             // factor rows a panel
  const int width = min(TN, m - col0);  // a multiple of MIN_BS
  const int wr0 = 16 * warp;            // this warp's panel rows
  const int cw = 8 * warp;              // this warp's columns of the panel
  const T* Bsub = B + s * (int64_t)n * m;
  const T* Linvs = Linv + s * (int64_t)nb * bs * bs;
  T* Ys = Y + s * (int64_t)n * m;

  zero_rows(Ys, start * bs, m, col0, width);

  for (int k0 = start; k0 < nb; k0 += G) {
    const int rows = min(G, nb - k0) * bs;  // the panel's rows that exist
    const int r0 = k0 * bs;                 // its first row of L, B and Y
    T acc[2][NJ][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wr0 + 8 * i + g;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const P v = r < rows && 8 * j < width
                        ? __ldg(reinterpret_cast<const P*>(
                              Bsub + (int64_t)(r0 + r) * m + col0 + 8 * j +
                              2 * t))
                        : tile::pair<T>(0, 0);
        acc[i][j][0] = v.x;
        acc[i][j][1] = v.y;
      }
    }

    // acc -= L[panel, start:k0] Y[start:k0]; the last chunk is zero-filled
    // past k0
    const int c_begin = start * bs;
    dmma::pipeline<STAGES>(
        (r0 - c_begin + KC - 1) / KC,
        [&](int c, int stage) {
          T* As = ring + stage * ST;
          const int c0 = c_begin + c * KC;
          for (int idx = tid; idx < rows * (KC / V); idx += THREADS) {
            const int r = idx / (KC / V), q = V * (idx % (KC / V));
            const bool in = c0 + q < r0;
            const T* src = fac.L + (int64_t)(r0 + r) * n + c0 + q;
            dmma::cp_async_cg(As + r * ALD + q, in ? src : fac.L, in);
          }
          for (int idx = tid; idx < KC * (TN / V); idx += THREADS) {
            const int q = idx / (TN / V), cv = V * (idx % (TN / V));
            const bool in = c0 + q < r0 && cv < width;
            const T* src = Ys + (int64_t)(c0 + q) * m + col0 + cv;
            dmma::cp_async_cg(As + A_ST + q * LD + cv, in ? src : Ys, in);
          }
        },
        [&](int, int stage) {
          const T* As = ring + stage * ST;
          if (wr0 < rows)  // warp-uniform
            tile::mma<2, NJ, KC, ALD, 1, LD, true>(acc, As + wr0 * ALD,
                                                   As + A_ST);
        });

    // the sums into Cs; the diagonal panel and its Linv blocks into the ring
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<P*>(Cs + (wr0 + 8 * i + g) * LD + 8 * j + 2 * t) =
            tile::pair<T>(acc[i][j][0], acc[i][j][1]);
    for (int idx = tid; idx < rows * (PROWS / V); idx += THREADS) {
      const int r = idx / (PROWS / V), q = V * (idx % (PROWS / V));
      const bool in = q < rows;
      const T* src = fac.L + (int64_t)(r0 + r) * n + r0 + q;
      dmma::cp_async_cg(Ds + r * D_LD + q, in ? src : fac.L, in);
    }
    // the panel's Linv blocks are consecutive: panel row r, column q of
    // its block at Linvs[r0 * bs + r * bs + q]
    for (int idx = tid; idx < rows * (bs / V); idx += THREADS) {
      const int r = idx / (bs / V), q = V * (idx % (bs / V));
      dmma::cp_async_cg(Is + r * LINV_LD + q,
                        Linvs + (int64_t)r0 * bs + r * bs + q);
    }
    dmma::cp_async_commit();
    dmma::cp_async_wait<0>();
    __syncthreads();

    // columns [cw, cw + 8) of the panel, one factor row (bs rows) a step
    for (int rb = 0; rb < rows; rb += bs) {
      T x[2][1][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const P v = 8 * i < bs
                        ? *reinterpret_cast<const P*>(
                              Cs + (rb + 8 * i + g) * LD + cw + 2 * t)
                        : tile::pair<T>(0, 0);
        x[i][0][0] = v.x;
        x[i][0][1] = v.y;
      }
      // x -= L[b, :b] Y[:b], Y[:b] already in Cs
      for (int kk = 0; kk < rb; kk += 8)
        tile::mma<2, 1, 8, D_LD, 1, LD, true>(x, Ds + rb * D_LD + kk,
                                              Cs + kk * LD + cw);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (8 * i < bs)
          *reinterpret_cast<P*>(Cs + (rb + 8 * i + g) * LD + cw + 2 * t) =
              tile::pair<T>(x[i][0][0], x[i][0][1]);
      __syncwarp();
      // Y_b = Linv_b x
      T out[2][2] = {};
      for (int kk = 0; kk < bs; kk += 8) {
        T a[4], b[2];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = Is[(rb + 8 * (q & 1) + g) * LINV_LD + kk + t + 4 * (q >> 1)];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          b[q] = Cs[(rb + kk + t + 4 * q) * LD + cw + g];
        tile::frag_mma(out[0], out[1], a, b);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rb + 8 * i + g;
        if (8 * i < bs) {
          const P y = tile::pair<T>(out[i][0], out[i][1]);
          *reinterpret_cast<P*>(Cs + r * LD + cw + 2 * t) = y;
          if (cw < width)
            *reinterpret_cast<P*>(Ys + (int64_t)(r0 + r) * m + col0 + cw +
                                  2 * t) = y;
        }
      }
      __syncwarp();
    }
    // the panel's Y is read back (through L2) by later panels; the ring and
    // Cs are rewritten
    __syncthreads();
  }
}

// The forward substitution of one column tile: for KC == SMALL (bs <=
// SMALL_MAX_BS) the panel core on a dense factor and the k-split core on a
// packed one, else the row-split core with KC-deep chunks (KC divides bs)
// in PASSES passes (row_passes(bs)).
template <class T, int KC, int PASSES, class Factor>
__device__ __forceinline__ void solve_tile(const Factor& factor,
                                           const T* Linv, const T* B, T* Y,
                                           int64_t s, int col0, int start,
                                           int n, int m, int bs, T* smem) {
  if constexpr (KC != SMALL)
    solve_column_tile<T, KC, PASSES>(factor, Linv, B, Y, s, col0, start, n,
                                     m, bs, smem);
  else if constexpr (Factor::contiguous)
    solve_column_tile_panel<T>(factor, Linv, B, Y, s, col0, start, n, m, bs,
                               smem);
  else
    solve_column_tile_ksplit<T>(factor, Linv, B, Y, s, col0, start, n, m,
                                bs, smem);
}

template <class T, int KC, int PASSES, class Factor>
constexpr size_t solve_smem_bytes() {
  return KC != SMALL           ? trsm_smem_bytes<T, PASSES>()
         : Factor::contiguous ? panel_smem_bytes<T>()
                              : ksplit_smem_bytes<T>();
}

// the KC, and so the core, a launcher instantiates for bs (a multiple of
// MIN_BS): SMALL for small blocks, else the row-split core's chunks
// ROW_KC<T> deep where that divides bs, else 16 where 16 does, else 8
template <class T>
constexpr int chunk_depth(int bs) {
  return bs <= SMALL_MAX_BS     ? SMALL
         : bs % ROW_KC<T> == 0 ? ROW_KC<T>
         : bs % 16 == 0        ? 16
                               : MIN_BS;
}

// f(integral_constant<int, KC>(), integral_constant<int, PASSES>()) for
// the core a launcher instantiates for bs (chunk_depth<T>(bs) and
// row_passes(bs); the small-block cores take one pass)
template <class T, int PASSES, class F>
int with_row_core(int kc, F& f) {
  using std::integral_constant;
  if (kc == ROW_KC<T>)
    return f(integral_constant<int, ROW_KC<T>>(),
             integral_constant<int, PASSES>());
  if (kc == 16)
    return f(integral_constant<int, 16>(), integral_constant<int, PASSES>());
  return f(integral_constant<int, MIN_BS>(), integral_constant<int, PASSES>());
}

template <class T, class F>
int with_core(int bs, F&& f) {
  const int kc = chunk_depth<T>(bs);
  if (kc == SMALL)
    return f(std::integral_constant<int, SMALL>(),
             std::integral_constant<int, 1>());
  return row_passes(bs) == 1 ? with_row_core<T, 1>(kc, f)
                             : with_row_core<T, 2>(kc, f);
}

}  // namespace stepped
