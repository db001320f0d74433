// Stepped TRSM for Hopper (sm_90a), f64 and f32: Y = L^{-1} B for a
// stepped B, batched over subdomains, against a dense or a packed factor.
//
// Replaces:
//   * stepped_trsm_f64, stepped_trsm_f32:
//     repro/kernels/stepped_trsm.py::stepped_trsm_pallas (body
//     _trsm_kernel), the TPU kernel of paper §3.2, at f64 and at f32 (the
//     TPU kernel accumulates f32 and bf16 inputs in f32; bf16 storage runs
//     its prep at f32, so these two cover every dtype it takes);
//   * stepped_trsm_packed_f64, stepped_trsm_packed_f32:
//     repro/kernels/stepped_trsm.py::stepped_trsm_packed_pallas (body
//     _trsm_packed_kernel), the same TRSM against a packed factor whose
//     inner loop walks only the stored blocks of each row. At f32 and bs >
//     16 that entry launches its own core, stepped_trsm_cluster.cuh (the
//     column tiles of a stripe as one cluster, sharing each factor and Linv
//     chunk by TMA multicast); every other instance is the row, panel or
//     k-split core below.
//
// What bounds them (f64): the card's least time for the work is the f64
// operations (dense: SteppedMeta.flops_trsm_rhs_split() per subdomain,
// times S, about 0.18 TFLOP on feti-heat-2d's 64 subdomains of 4225 DOFs,
// 2.7 ms at the FP64 tensor cores' 67 TFLOP/s) or, packed, the bytes of
// the stored factor tiles (142 of 595 lower blocks there; ~2.5 GB with B,
// Linv and Y, 0.75 ms at 3.35 TB/s). What bounds this design is shared
// memory: per 16-deep chunk a block copies 20 KB into it and its 4 warps
// load 32 KB of fragments from it, ~410 SM clocks at 128 B a clock, for
// 64 m16n8k8 products that the tensor cores finish in 256. So the kernels
// can reach at most about 60% of the FP64 peak; they reach about a third
// (PERF.md). Every warp loads the whole B operand (the solved Y rows).
//
// What the design does about it (the device code is stepped_trsm.cuh):
//   * Every block owns TN = 32 right-hand-side columns of one subdomain and
//     runs the whole forward substitution for them, starting at its
//     stripe's start block: the zero region above the column pivots is
//     never read (paper's RHS splitting). Pivots are sorted, so the
//     stripe's start is a valid lower bound for all of its columns.
//   * Narrow column tiles give S * m_pad / 32 independent blocks (768 at
//     full size) instead of the TPU grid's S * m_pad / 128 = 192, enough
//     to fill 132 SMs. Blocks are numbered column-tile-major, so the
//     tiles of the first stripes, which start highest and cost the most,
//     are dispatched first (start blocks are non-decreasing), and the
//     blocks in flight for one subdomain read the same factor tiles,
//     which then stream from L2.
//   * The diagonal step multiplies by the pre-inverted diagonal block, as
//     on the TPU, so all arithmetic is GEMM-shaped and runs on the FP64
//     tensor cores (mma.sync m16n8k8, dmma_f64.cuh), with every operand
//     staged through a cp.async ring (3 stages, 112 KB of shared memory
//     at f64: two blocks of 4 warps a SM; at f32 2 stages of 32-deep
//     chunks, 68 KB: three blocks a SM). Four 32 x 32 warp tiles load a
//     third fewer fragments than eight 16 x 32 ones, and at 128 threads a
//     block ptxas may use up to 255 registers, so nothing spills.
//   * One template over the factor accessor: the packed kernel is the dense
//     one with the tile walk replaced by the CSR walk over stored slots
//     from the first one at or right of the stripe's start (exact: Y is
//     zero left of it).
//   * Each block still solves its rows one after another: a barrier per
//     chunk, and the pipeline drains at each diagonal step.
//   * f32: the products run on the TF32 tensor cores at f32 accuracy, three
//     TF32 products each (3xTF32, tf32x3_f32.cuh), accumulating in f32 as
//     the TPU kernel does. The f32 work's least time is its operations at
//     3 x 1/494.7 TFLOP/s (1.1 ms at feti-heat-2d's shapes) or its bytes.
//     The products are not what bounds the f32 row core: 3xTF32 alone, in
//     place of FFMA, left its time where it was (PERF.md), while chunks 32
//     deep instead of 16 (half the barriers and ring round trips a row)
//     took a fifth off, and a 2-stage ring, three blocks a SM, a further
//     eighth at feti-heat-3d's Dirichlet stage. Each 32-column tile copies
//     its rows' whole factor panel from L2 (12 GB at feti-heat-2d, 30 GB at
//     the Dirichlet stage). The packed f32 TRSM's own core
//     (stepped_trsm_cluster.cuh) shares those copies between the tiles of
//     a stripe, and measured that they are not what bounds the f32 core
//     (PERF.md §6); the dense one still copies them a tile at a time.
//   * Small blocks (bs <= 16; the smoke configurations' bs = 8): the panel
//     core on the dense factor takes 64 rows (64 / bs factor rows) a pass,
//     16 a warp: every warp works, and Y, which each factor row would
//     otherwise read again down to the start (15 GB at bs = 16 on
//     feti-heat-2d's shapes), is read once a panel. The panel's diagonal
//     is solved in shared memory, each warp its own 8 columns. On the
//     packed factor the rows of a panel walk different stored slots, so the
//     k-split core takes one factor row at a time, up to 64 / bs stored
//     tiles a chunk, every warp a quarter of the chunk's depth. Column
//     tiles past m (bm < 32) are clipped.
//   * Large blocks (128 < bs <= 256; the reference's planner offers bs 256
//     whenever n >= 256): the row core takes a block's rows in two passes
//     of 128 over the same 4 warps, so one core, one accumulator and one
//     thread count serve every bs >= 24, and the fused kernels' SYRK half,
//     written for 128 threads, is unchanged. Each pass subtracts every
//     earlier block's contribution from its rows first; only then does the
//     diagonal step multiply by the block's whole inverse from
//     invert_diag_blocks(L, bs) (the top pass by its leading 128 columns,
//     the rest of its rows being zero), exactly the TPU kernel's step. What
//     it costs: both passes' sums sit in shared memory at once (149 KB a
//     block at f64: one block a SM, against two at bs 128; 88 KB at f32),
//     and each pass copies the Y rows of its chunks again.
//
// Layout: row-major, Linv (S, nb, bs, bs), L (S, n, n) or values
// (S, n_blocks, bs, bs) with rowptr (nb + 1,) and colidx (n_blocks,)
// int32, B and Y (S, n, m), start_block (m / bm,) int32 shared by all
// subdomains. n and m are padded to bs and bm multiples; bs is a multiple
// of 8 up to 256, bm a multiple of 8. Rows above a stripe's start come
// out exactly zero. A launcher returns cudaErrorInvalidValue for any other
// bs or bm.

#include "stepped_trsm.cuh"
#include "stepped_trsm_cluster.cuh"

namespace {

using namespace stepped;

template <class T, int KC, int PASSES, class Factor>
__global__ void __launch_bounds__(THREADS)
stepped_trsm_kernel(Factor fac, const T* __restrict__ Linv,
                    const T* __restrict__ B,
                    const int* __restrict__ start_block, T* __restrict__ Y,
                    int S, int n, int m, int bs, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col0 = (int)(blockIdx.x / S) * TN;
  const int start = min(start_block[col0 / bm], n / bs);
  solve_tile<T, KC, PASSES>(fac, Linv, B, Y, (int64_t)(blockIdx.x % S), col0,
                            start, n, m, bs, reinterpret_cast<T*>(smem_raw));
}

template <class T, int KC, int PASSES, class Factor>
int launch_kc(Factor fac, const T* Linv, const T* B, const int* start_block,
              T* Y, int S, int n, int m, int bs, int bm, cudaStream_t stream) {
  auto kernel = stepped_trsm_kernel<T, KC, PASSES, Factor>;
  constexpr size_t smem = solve_smem_bytes<T, KC, PASSES, Factor>();
  cudaError_t err = dmma::set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((m + TN - 1) / TN) * S;
  kernel<<<grid, THREADS, smem, stream>>>(
      fac, Linv, B, start_block, Y, S, n, m, bs, bm);
  return (int)cudaGetLastError();
}

template <class T, class Factor>
int launch(Factor fac, const void* Linv, const void* B,
           const void* start_block, void* Y, int S, int n, int m, int bs,
           int bm, void* stream) {
  if (bs % MIN_BS || bs > MAX_BS || bs < MIN_BS || bm % MIN_BS || bm < 1 ||
      n % bs || m % bm)
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value && !Factor::contiguous) {
    // the packed f32 TRSM: its cluster core above SMALL_MAX_BS
    // (stepped_trsm_cluster.cuh), the k-split core at and below it
    if (bs > SMALL_MAX_BS)
      return trsm_cluster::launch(fac.values, fac.rowptr, fac.colidx,
                                  fac.n_blocks, (const float*)Linv,
                                  (const float*)B, (const int*)start_block,
                                  (float*)Y, S, n, m, bs, bm,
                                  (cudaStream_t)stream);
    return launch_kc<T, SMALL, 1>(fac, (const T*)Linv, (const T*)B,
                                  (const int*)start_block, (T*)Y, S, n, m, bs,
                                  bm, (cudaStream_t)stream);
  } else {
    return with_core<T>(bs, [&](auto kc, auto passes) {
      return launch_kc<T, decltype(kc)::value, decltype(passes)::value>(
          fac, (const T*)Linv, (const T*)B, (const int*)start_block, (T*)Y, S,
          n, m, bs, bm, (cudaStream_t)stream);
    });
  }
}

}  // namespace

#define STEPPED_TRSM_ENTRY(T, SUFFIX)                                         \
  extern "C" int stepped_trsm_##SUFFIX(                                      \
      const void* Linv, const void* L, const void* B,                        \
      const void* start_block, void* Y, int S, int n, int m, int bs, int bm, \
      void* stream) {                                                        \
    return launch<T>(DenseFactor<T>{(const T*)L, n}, Linv, B, start_block,   \
                     Y, S, n, m, bs, bm, stream);                            \
  }                                                                          \
  extern "C" int stepped_trsm_packed_##SUFFIX(                               \
      const void* Linv, const void* values, const void* rowptr,              \
      const void* colidx, const void* B, const void* start_block, void* Y,   \
      int S, int n, int m, int bs, int bm, int n_blocks, void* stream) {     \
    return launch<T>(PackedFactor<T>{(const T*)values, (const int*)rowptr,   \
                                     (const int*)colidx, n_blocks},          \
                     Linv, B, start_block, Y, S, n, m, bs, bm, stream);      \
  }

STEPPED_TRSM_ENTRY(double, f64)
STEPPED_TRSM_ENTRY(float, f32)

// the column tiles a cluster of stepped_trsm_packed_f32 takes at bm (bs >
// SMALL_MAX_BS): kernels/_launch.py::cluster_tiles is held to it
extern "C" int stepped_trsm_cluster_tiles(int bm) {
  return trsm_cluster::cluster_tiles(bm);
}

// *clusters: how many clusters of `cluster` blocks of that kernel's
// instance for bs (> SMALL_MAX_BS) the current card holds at once
extern "C" int stepped_trsm_cluster_resident(int bs, int cluster,
                                             int* clusters) {
  if (bs % MIN_BS || bs <= SMALL_MAX_BS || bs > MAX_BS || cluster < 1 ||
      cluster > trsm_cluster::MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  return trsm_cluster::resident(bs, cluster, clusters);
}
