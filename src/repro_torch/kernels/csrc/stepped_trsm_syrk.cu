// Fused stepped TRSM -> SYRK for Hopper (sm_90a), f64 and f32: the lower
// block triangle of F = (L^{-1} B)^T (L^{-1} B) in one launch, batched over
// subdomains, against a dense or a packed factor.
//
// Replaces:
//   * stepped_trsm_syrk_f64, stepped_trsm_syrk_f32:
//     repro/kernels/stepped_trsm_syrk.py::stepped_trsm_syrk_pallas (body
//     _fused_kernel), at f64 and at f32 (the TPU kernel accumulates f32 and
//     bf16 inputs in f32 and keeps its output and Y at the input dtype;
//     bf16 storage runs its prep at f32, so these two cover every dtype it
//     takes);
//   * stepped_trsm_syrk_packed_f64, stepped_trsm_syrk_packed_f32:
//     repro/kernels/stepped_trsm_syrk.py::stepped_trsm_syrk_packed_pallas
//     (body _fused_packed_kernel), the same with the packed factor's
//     forward substitution.
//
// What bounds them: the operations of the TRSM half (see stepped_trsm.cu),
// about ten times those of the SYRK half; the bytes that must move are the
// factor, Linv, B and F (Y need not leave the chip). At f64 both halves run
// on the FP64 tensor cores (stepped_trsm.cuh, stepped_syrk.cuh). At f32
// both halves run 3xTF32 on the TF32 tensor cores (tf32x3_f32.cuh),
// accumulating in f32, the same device code templated on the scalar type T;
// the f32 bound is the operations at 3xTF32's rate (three TF32 products at
// 494.7 TFLOP/s each) or the bytes.
// Beyond the arithmetic, what decides the time is balance: one TRSM item
// (a 32-column tile) of the stripe that starts at block 0 costs
// sum_{k<nb} (k + 1) tile products (595 at nb = 34), one of a stripe that
// starts near the end a few, and the start-0 items set the critical path.
// Even balanced, fusion saves little here: Y still goes through device
// memory, and a SYRK item can only start once its stripes are solved, so
// the SYRK half overlaps no more than the TRSM half's tail. On the dense
// factor the kernel's TRSM items alone run about 20% slower than the
// stepped TRSM's blocks on the same items, for a reason not found yet (not
// registers, residency or item order; PERF.md); on the packed one they
// match at bs = 128, and at bs = 16 run about 20% slower too (PERF.md).
//
// The TPU kernel runs its (nc, nc) grid sequentially in row-major order:
// program (c, 0) solves stripe c into a persistent VMEM scratch and every
// later program (c, j <= c) reads stripes c and j from it. CUDA blocks run
// in no order, so work order and readiness are explicit:
//   * A persistent grid, no larger than what is co-resident, draws items
//     from one host-built list (kernels/schedule.py) through one atomicAdd
//     ticket: first every TRSM item (subdomain, 32-column tile) in
//     non-increasing cost, then every SYRK item (subdomain, lower group
//     of stripes, 64 x 64 sub-tile; below), those reducing over the most
//     rows first. A block that drew a cheap item draws again at once, so
//     the heavy items spread over all SMs instead of a fixed stride's
//     share.
//   * A TRSM item runs stepped_trsm.cuh's forward substitution into a
//     global Y scratch (S, n, m), then publishes its column tile: every
//     thread fences, the block meets at a barrier, and one thread stores
//     the tile's ready flag with st.release.gpu.
//   * A SYRK item waits only for the column tiles it reads (its rows and
//     its columns of Y): one thread spins on their flags with
//     ld.acquire.gpu, then the block meets at a barrier and copies Y with
//     cp.async.cg (L2, never a stale L1 line, never the read-only path).
//     SYRK items of the early-finishing stripes run while the start-0
//     stripe is still being solved.
// The wrapper's launcher zeroes the ticket and the flags with
// cudaMemsetAsync on the same stream before every launch.
//
// Why no schedule can deadlock: a block waits only inside a SYRK item, and
// only for TRSM items. Tickets are handed out in increasing order and every
// TRSM item precedes every SYRK item in the list, so each TRSM item a
// waiting block needs was drawn before its own ticket, by a block that was
// running when it drew it. TRSM items never wait, so that block finishes
// the item and sets the flag. (The argument needs no co-residency; the
// grid is sized to what is co-resident only so that no block idles behind
// the queue.)
//
// Upper tiles (j > i) are never written: the wrapper allocates F as zeros,
// which the mirror step relies on.
//
// SYRK items follow groups of stripes, as the stepped SYRK's blocks do
// (stepped_syrk.cu), at this kernel's 64-wide region: a group is
// G = 64 / bm stripes when bm < 64, else one stripe, so G * bm columns
// wide (bm 8: 8 stripes, 16: 4, 24: 2 (48 wide), 32: 2, 40 to 56: 1).
// Only lower groups (gi >= gj) get items, each cut into 64 x 64 sub-tiles
// (more than one only when bm > 64) and clipped at the group's end and at
// m, so the last group may be narrower. syrk_tile reduces a region from
// its first row stripe's start, masks each column at its own stripe's
// start and stores only stripe pairs (i, j <= i), so pairs (i, j > i)
// inside a diagonal group keep the wrapper's zeros. One item a bm x bm
// tile would keep (bm / 64)^2 of its products and stage both 64-column
// panels over its whole k range: at feti-heat-2d's bs = bm = 16 (S 64,
// m 272) 9,792 SYRK items where 960 cover the same groups. At bm >= 64
// (G = 1) an item is a 64 x 64 sub-tile of one bm x bm tile.
//
// Small blocks (bs, bm in {8, 16, ...}): a TRSM item keeps its 32-column
// tile, which may span several stripes; it solves from the first one's
// start (stepped_trsm.cuh says why that is exact) and is clipped at m; at
// bs <= 16 it runs the panel core (dense) or the k-split core (packed) of
// stepped_trsm.cuh. A SYRK item waits for every column tile its rows and
// columns touch: a 64-wide region up to two (three when it starts
// off a 32-column boundary, as at bm 56) on each side, a region narrower
// than 32 the one it lies in.
//
// f32: Y and F are f32 (sizeof(T) sizes the Y scratch the wrapper
// allocates and every shared-memory stage); the sync words stay int32
// beside them, 4-byte words in their own allocation.
//
// Layout: as stepped_trsm.cu, plus the scratch Y (S, n, m), the output
// F (S, m, m), both of the operands' type, the item list (n_items,) int32
// and the sync words (1 + S * ceil(m / 32),) int32; bs a multiple of 8 up
// to 256, bm a multiple of 8. Item codes: a TRSM item is
// s * ceil(m / 32) + column tile, a SYRK item is S * ceil(m / 32) +
// (s * lower groups + group) * subs^2 + sub, with groups =
// ceil((m / bm) / G), lower groups = groups * (groups + 1) / 2 (group
// (gi, gj) at gi * (gi + 1) / 2 + gj) and subs = ceil(G * bm / 64); its
// region starts at row gi * G * bm + (sub / subs) * 64 and column
// gj * G * bm + (sub % subs) * 64. The launcher takes only the whole
// list: an n_items other than its own count of every item (a list built
// for another FUSED_TILE or for one item a bm x bm tile, say) is refused
// with cudaErrorInvalidValue, as are bs and bm the TRSM core does not
// take. stepped_trsm_syrk_grid_{f64,f32}(bs, packed, &blocks) reports the
// persistent grid a launch at bs takes on this card.

#include <type_traits>

#include "stepped_syrk.cuh"
#include "stepped_trsm.cuh"

namespace {

using namespace stepped;

// SYRK region edge: 4 warps of 32 x 32. 128 x 128 regions at the TRSM
// core's 128 threads would need 64 x 64 warp tiles, 256 accumulator
// registers a thread at f64.
constexpr int FUSED_TILE = 64;

// the larger of the two halves' shared memory (the TRSM half's: the row
// core's 112 KB at f64 and 68 KB at f32, 149 KB and 88 KB at bs > 128, the
// panel core's 101 KB and 93 KB, the k-split core's 100 KB and 54 KB)
template <class T, int KC, int PASSES, class Factor>
constexpr size_t fused_smem_bytes() {
  return solve_smem_bytes<T, KC, PASSES, Factor>() >
                 syrk_smem_bytes<T, FUSED_TILE>()
             ? solve_smem_bytes<T, KC, PASSES, Factor>()
             : syrk_smem_bytes<T, FUSED_TILE>();
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <class T, int KC, int PASSES, class Factor>
__global__ void __launch_bounds__(THREADS)
stepped_trsm_syrk_kernel(Factor fac, const T* __restrict__ Linv,
                         const T* __restrict__ B,
                         const int* __restrict__ start_block,
                         const int* __restrict__ order, int n_items,
                         int* sync, T* Y, T* __restrict__ F, int S, int n,
                         int m, int bs, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int item_s;
  int* ticket = sync;
  int* ready = sync + 1;  // one flag per (subdomain, column tile)
  const int nb = n / bs;
  const int col_tiles = (m + TN - 1) / TN;
  const int trsm_items = S * col_tiles;

  for (;;) {
    if (threadIdx.x == 0) {
      const int t = atomicAdd(ticket, 1);
      item_s = t < n_items ? order[t] : -1;
    }
    __syncthreads();
    const int item = item_s;
    __syncthreads();  // item_s is rewritten only after every thread read it
    if (item < 0) break;

    if (item < trsm_items) {
      const int64_t s = item / col_tiles;
      const int col0 = (item % col_tiles) * TN;
      const int start = min(start_block[col0 / bm], nb);
      solve_tile<T, KC, PASSES>(fac, Linv, B, Y, s, col0, start, n, m, bs,
                                smem);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) store_release(ready + item, 1);
      continue;
    }

    // decoded here, not above the loop: nothing of it is live in a TRSM item
    const int g = group_stripes<FUSED_TILE>(bm), width = g * bm;
    const int groups = (m / bm + g - 1) / g;
    const int subs = (width + FUSED_TILE - 1) / FUSED_TILE;
    const int per_group = subs * subs;
    const int per_s = groups * (groups + 1) / 2 * per_group;
    const int code = item - trsm_items;
    const int64_t s = code / per_s;
    const int rem = code % per_s;
    int gi, gj;
    lower_tile(rem / per_group, gi, gj);
    const int sub = rem % per_group;
    const int r0 = gi * width + (sub / subs) * FUSED_TILE;
    const int c0 = gj * width + (sub % subs) * FUSED_TILE;
    const int row_end = min(min(r0 + FUSED_TILE, (gi + 1) * width), m);
    const int col_end = min(min(c0 + FUSED_TILE, (gj + 1) * width), m);
    if (threadIdx.x == 0) {
      const int* flags = ready + s * col_tiles;
      for (int c = r0 / TN; c < (row_end + TN - 1) / TN; ++c)
        while (!load_acquire(flags + c)) __nanosleep(128);
      for (int c = c0 / TN; c < (col_end + TN - 1) / TN; ++c)
        while (!load_acquire(flags + c)) __nanosleep(128);
    }
    __syncthreads();
    syrk_tile<T, LoadFromL2, FUSED_TILE, 32, 32, THREADS>(
        Y + s * (int64_t)n * m, F + s * (int64_t)m * m, n, m,
        Stripes{start_block, bs, bm, nb}, r0, c0, row_end, col_end, smem);
  }
}

// Blocks of `kernel` that fit on the card at once (the persistent grid),
// each with `smem` bytes of dynamic shared memory.
template <class Kernel>
cudaError_t resident_blocks(Kernel* kernel, size_t smem, int* blocks) {
  cudaError_t err = dmma::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <class T, int KC, int PASSES, class Factor>
int launch_kc(Factor fac, const void* Linv, const void* B,
              const void* start_block, const void* order, int n_items,
              void* sync, void* Y, void* F, int S, int n, int m, int bs,
              int bm, void* stream) {
  auto kernel = stepped_trsm_syrk_kernel<T, KC, PASSES, Factor>;
  constexpr size_t smem = fused_smem_bytes<T, KC, PASSES, Factor>();
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int grid = n_items < resident ? n_items : resident;
  const int trsm_items = S * ((m + TN - 1) / TN);
  err = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + trsm_items),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      fac, (const T*)Linv, (const T*)B, (const int*)start_block,
      (const int*)order, n_items, (int*)sync, (T*)Y, (T*)F, S, n, m, bs, bm);
  return (int)cudaGetLastError();
}

template <class T, class Factor>
int launch(Factor fac, const void* Linv, const void* B,
           const void* start_block, const void* order, int n_items,
           void* sync, void* Y, void* F, int S, int n, int m, int bs, int bm,
           void* stream) {
  if (bs % MIN_BS || bs > MAX_BS || bs < MIN_BS || bm % MIN_BS || bm < 1 ||
      n % bs || m % bm)
    return (int)cudaErrorInvalidValue;
  const int g = group_stripes<FUSED_TILE>(bm), width = g * bm;
  const int groups = (m / bm + g - 1) / g;
  const int subs = (width + FUSED_TILE - 1) / FUSED_TILE;
  const int trsm_items = S * ((m + TN - 1) / TN);
  if (n_items != trsm_items + S * (groups * (groups + 1) / 2) * subs * subs)
    return (int)cudaErrorInvalidValue;
  return with_core<T>(bs, [&](auto kc, auto passes) {
    return launch_kc<T, decltype(kc)::value, decltype(passes)::value>(
        fac, Linv, B, start_block, order, n_items, sync, Y, F, S, n, m, bs,
        bm, stream);
  });
}

// the persistent grid launch() takes at bs on this card
template <class T, class Factor>
int grid_blocks(int bs, int* blocks) {
  if (bs % MIN_BS || bs > MAX_BS || bs < MIN_BS)
    return (int)cudaErrorInvalidValue;
  return with_core<T>(bs, [&](auto kc, auto passes) {
    constexpr int KC = decltype(kc)::value, PASSES = decltype(passes)::value;
    return (int)resident_blocks(
        stepped_trsm_syrk_kernel<T, KC, PASSES, Factor>,
        fused_smem_bytes<T, KC, PASSES, Factor>(), blocks);
  });
}

}  // namespace

#define STEPPED_TRSM_SYRK_ENTRY(T, SUFFIX)                                    \
  extern "C" int stepped_trsm_syrk_##SUFFIX(                                 \
      const void* Linv, const void* L, const void* B,                        \
      const void* start_block, const void* order, void* sync, void* Y,       \
      void* F, int S, int n, int m, int bs, int bm, int n_items,             \
      void* stream) {                                                        \
    return launch<T>(DenseFactor<T>{(const T*)L, n}, Linv, B, start_block,   \
                     order, n_items, sync, Y, F, S, n, m, bs, bm, stream);   \
  }                                                                          \
  extern "C" int stepped_trsm_syrk_packed_##SUFFIX(                          \
      const void* Linv, const void* values, const void* rowptr,              \
      const void* colidx, const void* B, const void* start_block,            \
      const void* order, void* sync, void* Y, void* F, int S, int n, int m,  \
      int bs, int bm, int n_blocks, int n_items, void* stream) {             \
    return launch<T>(PackedFactor<T>{(const T*)values, (const int*)rowptr,   \
                                     (const int*)colidx, n_blocks},          \
                     Linv, B, start_block, order, n_items, sync, Y, F, S, n, \
                     m, bs, bm, stream);                                     \
  }                                                                          \
  extern "C" int stepped_trsm_syrk_grid_##SUFFIX(int bs, int packed,         \
                                                 int* blocks) {              \
    return packed ? grid_blocks<T, PackedFactor<T>>(bs, blocks)              \
                  : grid_blocks<T, DenseFactor<T>>(bs, blocks);              \
  }

STEPPED_TRSM_SYRK_ENTRY(double, f64)
STEPPED_TRSM_SYRK_ENTRY(float, f32)
