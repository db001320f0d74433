// The packed f32 stepped TRSM's own core (bs 24 to 256): the column tiles
// of a stripe solve as one thread-block cluster and share every factor and
// Linv chunk through TMA multicast. Sm_90a, f32.
//
// Replaces: repro/kernels/stepped_trsm.py::stepped_trsm_packed_pallas (body
// _trsm_packed_kernel) at f32, for bs > SMALL_MAX_BS (stepped_trsm.cu's
// stepped_trsm_packed_f32 reaches it; at bs <= 16 that entry keeps the
// k-split core of stepped_trsm.cuh). It computes what the TPU kernel does:
//
//   Y[k] = Linv[k] (B[k] - sum_{slots t of row k, colidx[t] >= start}
//                          values[t] Y[colidx[t]]),  k >= start,
//
// rows above a tile's start written as zeros, columns at or past m neither
// read nor written, each product 3xTF32 on mma.sync m16n8k8 with a fresh
// accumulator a k8 step merged by round-to-nearest adds (tf32x3_f32.cuh:
// the accuracy ROADMAP C6's guards rest on).
//
// What bounds it on the card: at feti-heat-2d's packed f32 shapes the work's
// least time is its bytes (0.373 ms at 3.35 TB/s on an NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md §6). The row core it replaces (solve_column_tile
// in stepped_trsm.cuh) copied far more than that from L2 into shared
// memory: each 32-column tile copies its rows' whole factor panel and its
// Linv blocks on its own, 2.94 GB of factor and 0.91 GB of Linv chunks on
// feti-heat-2d, 15.33 and 3.29 GB at feti-heat-3d's Dirichlet stage,
// against 0.45 GB of distinct slots, with a __syncthreads a chunk. Measured
// (PERF.md §6, the same card): those copies are not what bounds it. The
// ring below with one block a cluster, the parent's copies, runs 2.2 ms ->
// 1.85 ms at feti-heat-2d; sharing them four ways takes the copies to a
// fourth and the time to 1.9 ms; with its products skipped the ring alone
// takes 1.0-1.2 ms. What remains is the consumer warps' products and
// the rows' order: 4 warps a block, three blocks a SM, each k8 step of a
// warp loads, splits and multiplies in sequence.
//
// What the design does about it:
//   * The c = bm / 32 column tiles of one bm stripe of one subdomain (c <= 4,
//     cluster_tiles(): a stripe of more tiles takes several clusters; c = 1
//     where bm is no multiple of 32) are one thread-block cluster, its
//     blocks consecutive in the grid, the stripes with the earliest start
//     dispatched first. They share the start, so they walk the
//     same slots in the same order: each factor chunk and each Linv chunk of
//     the diagonal step is loaded once a cluster, by one TMA
//     (cp.async.bulk.tensor.2d) multicast into every block's ring stage. The
//     blocks take turns loading (chunk q by cluster rank q mod c). Factor
//     and Linv chunk traffic drops to 1/c; the Y rows, which differ between
//     the tiles, are still copied by each block with cp.async.cg.
//   * A producer warp fills the ring; the four consumer warps keep the row
//     core's layout (a pass of 128 accumulator rows, 32 x 32 a warp; two
//     passes for bs > 128). Each stage has a full mbarrier (the TMA's bytes
//     by expect_tx, the producer's Y copies by cp.async.mbarrier.arrive), a
//     consumed one (this block's consumer warps) and an empty one: once its
//     consumers are done with a stage, each block's producer sends one
//     arrival to every block of the cluster (mapa + a remote arrive), and
//     the block that loads the stage's next box waits for all of them. No
//     __syncthreads a chunk: the consumers wait on full barriers only, and
//     the producer runs a stage ahead, a row's diagonal Linv chunks under
//     its off-diagonal products. It takes each row of Y from the consumers
//     (a named barrier) only before the first chunk that reads it.
//   * Two stages of 32-deep chunks (64 KB) let three blocks share a SM,
//     and the cluster launch asks for the LoadBalancing placement: both
//     measured faster than deeper rings in two blocks and than the default
//     or Spread placements (PERF.md §6: the stripes of feti-heat-2d walk
//     34, 18 and 2 rows, so where a cluster's blocks land decides how the
//     long ones share their SMs).
//   * Chunks are KC deep (32 where it divides bs, else 16, else 8), a box of
//     KC columns x min(bs, 128) rows of values viewed as (S n_blocks bs, bs)
//     or of Linv as (S nb bs, bs), one tensor map each, encoded at every
//     launch. TMA writes a box densely, so the row core's padded leading
//     dimension cannot be had: the box is swizzled (KC * 4 bytes: 128B, 64B,
//     32B) and the fragment loads apply the same XOR, which keeps them free
//     of bank conflicts. A box's rows past the pass (bs < 128; the second
//     pass of bs > 128, whose box runs into the next block) are stale or
//     the next block's, computed and never stored.
//   * The diagonal step skips the Linv chunks above a warp's rows (Linv[k]
//     is lower triangular).
//   * Blocks barrier the whole cluster after initialising the mbarriers and
//     again before exiting, so no multicast lands in, and no arrival
//     reaches, a block that is not there.
//
// Layout as stepped_trsm.cu's: Linv (S, nb, bs, bs), values (S, n_blocks,
// bs, bs) with rowptr (nb + 1,) and colidx (n_blocks,) int32, B and Y (S,
// n, m), start_block (m / bm,) int32. The launcher returns a CUDA error code,
// or ENCODE_FAILED plus libcuda's CUresult when a tensor map cannot be
// encoded; cudaErrorLaunchOutOfResources when no cluster fits the card.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "stepped_trsm.cuh"

namespace trsm_cluster {

using stepped::PackedFactor;
using stepped::ROWS;
using stepped::TN;
using stepped::WROWS;

// blocks a cluster: 4, not the portable 8, which measured slower than the
// row core at bs = bm = 256 (PERF.md §6) where 4 measured faster
constexpr int MAX_CLUSTER = 4;
constexpr int WARPS = 4;           // consumer warps (the row core's)
constexpr int CONSUMERS = 32 * WARPS;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MI = WROWS / 8;
constexpr int NJ = TN / 8;
constexpr int Y_LD = stepped::Y_LD<float>;  // [KC][Y_LD] Y chunks, Cs
constexpr int ENCODE_FAILED = 10000;
constexpr int MAX_KC = 32;  // the deepest chunk: a 128-byte row
// ring depth: 2 stages of 32-deep chunks at one pass (64 KB: three blocks
// a SM, which measured faster than 4 stages in two), 3 at two passes (105
// KB: two blocks); shallower chunks as many bytes in more stages
template <int KC, int PASSES>
constexpr int RING = (PASSES == 1 ? 2 : 3) * (MAX_KC / KC);
// where the card places a cluster's blocks: LoadBalancing measured faster
// than Spread and the default at feti-heat-2d's shapes, whose first stripes
// walk 17 times the rows of the last
constexpr cudaClusterSchedulingPolicy CLUSTER_POLICY =
    cudaClusterSchedulingPolicyLoadBalancing;
constexpr int SWIZZLE_ALIGN = 1024;  // the 128B swizzle's repeat
constexpr int SM_SMEM = 233472;      // shared memory of an H100 SM
static_assert(stepped::THREADS == CONSUMERS, "the row core's warps");

// the column tiles of one bm stripe that form a cluster: bm / 32 (or its
// largest divisor up to MAX_CLUSTER) where bm is a multiple of 32, else 1
inline int cluster_tiles(int bm) {
  if (bm % TN) return 1;
  const int t = bm / TN;
  for (int c = std::min(t, MAX_CLUSTER); c > 1; --c)
    if (t % c == 0) return c;
  return 1;
}

// ring stages (A chunk [ROWS][KC] swizzled, Y chunk [KC][Y_LD]), Cs
// [PASSES * ROWS][Y_LD], the full, consumed and empty barriers, and room
// to align
template <int KC, int PASSES>
constexpr size_t smem_bytes() {
  return SWIZZLE_ALIGN +
         sizeof(float) * (RING<KC, PASSES> * (ROWS * KC + KC * Y_LD) +
                          PASSES * ROWS * Y_LD) +
         3 * RING<KC, PASSES> * sizeof(uint64_t);
}

// the blocks a SM that this shared memory leaves room for (1 KB of it
// reserved a block), at most 3: ptxas is held to their share of registers
template <int KC, int PASSES>
constexpr int blocks_per_sm() {
  const int b = (int)(SM_SMEM / (smem_bytes<KC, PASSES>() + 1024));
  return b < 1 ? 1 : b > 3 ? 3 : b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// waits until this block's phase of `bar` with parity `parity` has
// completed. A wait that outlasts WAIT_LIMIT_CLOCKS (about 10 s) traps: a
// fault in the ring ends the launch with an error instead of hanging the
// card.
constexpr long long WAIT_LIMIT_CLOCKS = 20000000000ll;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done) {
      const long long now = clock64();
      if (!t0)
        t0 = now;
      else if (now - t0 > WAIT_LIMIT_CLOCKS)
        __trap();
    }
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// an arrival on the barrier at `bar`'s offset in cluster block `rank`
// (release at CTA scope, as a local arrival: it orders this warp's reads of
// the stage, nothing else, before the refill; a cluster-scope release would
// fence the row's global stores of Y at every chunk)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar,
                                                   uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// a (x, y) box of `map` into this block's shared memory at dst, or with
// more than one block a cluster into every block's, completing on the
// barrier at `bar`'s offset in each
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar,
                                         int cluster) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  if (cluster == 1)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(desc), "r"(x), "r"(y), "r"(bar)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
            dst),
        "l"(desc), "r"(x), "r"(y), "r"(bar),
        "h"((uint16_t)((1u << cluster) - 1))
        : "memory");
}

// The XOR a KC-deep chunk's TMA swizzle applies to column k of row r (r and
// every row congruent to it mod 8): the 16-byte unit's bits [4, 4 + log2(KC
// / 4)) of the byte offset take bits [7, ...) of it, so element (r, k) is
// at r * KC + (k ^ swizzle_xor<KC>(r)).
template <int KC>
__device__ __forceinline__ int swizzle_xor(int r) {
  return (((r * KC) >> 5) & (KC / 4 - 1)) << 2;
}

// acc[i][j] += (-) sum_k A(wr0 + 8i + g, k) B(k, 8j + 2t + {0, 1}) over
// k < KC at f32 accuracy: A a swizzled [ROWS][KC] chunk, B [KC][Y_LD].
// tf32x3::warp_mma's products and order, with the chunk's XOR.
template <int KC, bool NEG>
__device__ __forceinline__ void mma_chunk(float (&acc)[MI][NJ][2],
                                          const float* A, int wr0,
                                          const float* B) {
  using namespace tf32x3;
  const int g = dmma::lane_g(), t = dmma::lane_t();
  const int x = swizzle_xor<KC>(g);  // every fragment row is g mod 8
#pragma unroll 1
  for (int k = 0; k < KC; k += 8) {
    uint32_t a_hi[MI / 2][4], a_lo[MI / 2][4], b_hi[NJ][2], b_lo[NJ][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = A[(wr0 + 16 * i + 8 * (q & 1) + g) * KC +
                          ((k + t + 4 * (q >> 1)) ^ x)];
        split(NEG ? -v : v, a_hi[i][q], a_lo[i][q]);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split(B[(k + t + 4 * q) * Y_LD + 8 * j + g], b_hi[j][q], b_lo[j][q]);
    float step[MI][NJ][2];
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8_new(step[2 * i][j], step[2 * i + 1][j], a_lo[i], b_hi[j]);
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8(step[2 * i][j], step[2 * i + 1][j], a_hi[i], b_lo[j]);
#pragma unroll
    for (int i = 0; i < MI / 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_16x8x8(step[2 * i][j], step[2 * i + 1][j], a_hi[i], b_hi[j]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j][0] += step[i][j][0];
        acc[i][j][1] += step[i][j][1];
      }
  }
}

// The ring's barriers and position. Producer and consumers each keep their
// own copy and advance it over the same sequence of chunks; chunk q sits in
// stage q mod RING, its (q / RING)-th use. A stage's barriers:
//   * full: the producer warp's 32 cp.async arrivals (its Y copies) and its
//     expect_tx of the box's bytes, which the TMA completes;
//   * consumed: this block's consumer warps, one arrival each;
//   * empty: one arrival from each block of the cluster, which its producer
//     forwards once its consumers are done; only the block that loads the
//     next box into the stage waits on it.
template <int RING_>
struct Ring {
  uint32_t bar0;  // shared address of full[0]; consumed[], empty[] follow
  int q;

  __device__ __forceinline__ uint32_t full(int st) const {
    return bar0 + 8 * st;
  }
  __device__ __forceinline__ uint32_t consumed(int st) const {
    return bar0 + 8 * (RING_ + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return bar0 + 8 * (2 * RING_ + st);
  }
};

// Columns [col0, col0 + TN) of subdomain s (clipped to m), the cluster's
// rank-th tile of its stripe. smem: smem_bytes<KC, PASSES>() - SWIZZLE_ALIGN,
// 1024-byte aligned. Every block of a cluster runs the same rows, passes
// and chunks.
template <int KC, int PASSES>
__device__ __forceinline__ void solve_cluster_tile(
    const CUtensorMap* fmap, const CUtensorMap* lmap,
    const PackedFactor<float>& fac, const float* B, float* Y, int64_t s,
    int col0, int start, int n, int m, int bs, int n_blocks, int cluster,
    int rank, float* smem) {
  using P = float2;
  constexpr int V = tile::VEC<float>;
  constexpr int RG = RING<KC, PASSES>;
  constexpr int A_ST = ROWS * KC;
  float* As = smem;                   // RG x [ROWS][KC], swizzled
  float* Ysm = smem + RG * A_ST;      // RG x [KC][Y_LD]
  float* Cs = Ysm + RG * KC * Y_LD;   // [PASSES * ROWS][Y_LD]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Cs + PASSES * ROWS * Y_LD);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nb = n / bs;
  const int cpt = bs / KC;                    // chunks per factor tile
  const int R = min(bs, ROWS);                // a box's rows
  const uint32_t tx = (uint32_t)(R * KC * sizeof(float));
  const int width = min(TN, m - col0);        // a multiple of MIN_BS
  float* Ys = Y + s * (int64_t)n * m;
  Ring<RG> ring{smem_u32(bars), 0};
  if (tid == 0) {
    for (int st = 0; st < RG; ++st) {
      mbar_init(ring.full(st), 32 + 1);
      mbar_init(ring.consumed(st), WARPS);
      mbar_init(ring.empty(st), cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // the number of chunks of row k: off-diagonal (a pass), diagonal (pass p)
  auto n_off = [&](int k) { return (fac.last(k) - fac.first(k, start)) * cpt; };
  auto n_diag = [&](int p) {
    return PASSES == 1 ? cpt : (p * ROWS + min(ROWS, bs - p * ROWS)) / KC;
  };

  if (warp == WARPS) {
    // producer: every chunk in the consumers' order. Chunk q goes into stage
    // st once this block's consumers have left its last use there: this
    // warp tells every block of the cluster so and copies its Y rows;
    // cluster rank q mod c, once every block has told it, loads the
    // factor or Linv box to every block.
    auto produce = [&](const CUtensorMap* map, int x, int y, const float* Yj) {
      const int q = ring.q++;
      const int st = q % RG;
      const uint32_t parity = (q / RG - 1) & 1;
      if (q >= RG) {
        mbar_wait(ring.consumed(st), parity);
        if (lane < cluster) mbar_arrive_remote(ring.empty(st), lane);
      }
      if (Yj)
        for (int idx = lane; idx < KC * (TN / V); idx += 32) {
          const int r = idx / (TN / V), cv = V * (idx % (TN / V));
          const bool in = cv < width;
          dmma::cp_async_cg(Ysm + st * KC * Y_LD + r * Y_LD + cv,
                            in ? Yj + (int64_t)r * m + cv : Yj, in);
        }
      mbar_arrive_cp_async(ring.full(st));
      if (lane == 0) {
        mbar_expect_tx(ring.full(st), tx);
        if (q % cluster == rank) {
          if (q >= RG) mbar_wait(ring.empty(st), parity);
          tma_load(smem_u32(As + st * A_ST), map, x, y, ring.full(st),
                   cluster);
        }
      }
    };
    // Y rows below `ready` are written: the consumers hand each row over
    // (named barrier 2) once they have stored it, and this warp takes the
    // hand-overs as late as it may: before the first chunk that reads the
    // row, and at the latest before the next row's diagonal chunks (the
    // consumers cannot finish that row, and hand over again, before those)
    int ready = start;
    auto need = [&](int row) {
      for (; ready <= row; ++ready) bar_sync(2, THREADS);
    };
    for (int k = start; k < nb; ++k) {
      const int it0 = fac.first(k, start);
      const int nc = n_off(k);
      for (int p = 0; p < PASSES; ++p)
        for (int c = 0; c < nc; ++c) {
          const int it = it0 + c / cpt, kc0 = (c % cpt) * KC;
          const int j = fac.col(it);
          need(j);
          produce(fmap, kc0, (int)((s * n_blocks + it) * bs + p * ROWS),
                  Ys + (int64_t)(j * bs + kc0) * m + col0);
        }
      need(k - 1);
      for (int p = 0; p < PASSES; ++p)
        for (int c = 0; c < n_diag(p); ++c)
          produce(lmap, c * KC, (int)((s * nb + k) * bs + p * ROWS), nullptr);
    }
  } else {
    // consumers: the row core's passes, each chunk waited for on its full
    // barrier and released to this block's producer
    const int g = dmma::lane_g(), t = dmma::lane_t();
    const int wr0 = warp * WROWS;
    const float* Bsub = B + s * (int64_t)n * m;
    auto consume = [&](int nchunks, auto&& compute) {
      for (int c = 0; c < nchunks; ++c) {
        const int q = ring.q++;
        const int st = q % RG;
        mbar_wait(ring.full(st), (q / RG) & 1);
        compute(c, st);
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.consumed(st));
      }
    };
    stepped::zero_rows(Ys, start * bs, m, col0, width);
    for (int k = start; k < nb; ++k) {
      const int nc = n_off(k);
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int pr0 = p * ROWS;
        const int rows = PASSES == 1 ? bs : min(ROWS, bs - pr0);
        const bool active = wr0 < rows;  // warp-uniform
        float acc[MI][NJ][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = wr0 + 8 * i + g;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const P v = r < rows && 8 * j < width
                            ? __ldg(reinterpret_cast<const P*>(
                                  Bsub + (int64_t)(k * bs + pr0 + r) * m +
                                  col0 + 8 * j + 2 * t))
                            : P{0.f, 0.f};
            acc[i][j][0] = v.x;
            acc[i][j][1] = v.y;
          }
        }
        consume(nc, [&](int, int st) {
          if (active)
            mma_chunk<KC, true>(acc, As + st * A_ST, wr0,
                                Ysm + st * KC * Y_LD);
        });
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            *reinterpret_cast<P*>(Cs + (pr0 + wr0 + 8 * i + g) * Y_LD +
                                  8 * j + 2 * t) =
                P{acc[i][j][0], acc[i][j][1]};
      }
      bar_sync(1, CONSUMERS);  // Cs complete
      // diagonal step, a pass at a time: Y[k] = Linv[k] Cs, the pass's rows
      // taking Cs rows [0, pr0 + rows) only (Linv[k] is lower triangular)
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int pr0 = p * ROWS;
        const int rows = PASSES == 1 ? bs : min(ROWS, bs - pr0);
        const bool active = wr0 < rows;
        float out[MI][NJ][2];
        tile::zero(out);
        // Linv[k]'s columns past the warp's last row are zero: its chunks
        // there are skipped
        consume(n_diag(p), [&](int c, int st) {
          if (active && c * KC < pr0 + wr0 + WROWS)
            mma_chunk<KC, false>(out, As + st * A_ST, wr0,
                                 Cs + c * KC * Y_LD);
        });
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = wr0 + 8 * i + g;
          if (r < rows) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              if (8 * j < width)
                *reinterpret_cast<P*>(Ys + (int64_t)(k * bs + pr0 + r) * m +
                                      col0 + 8 * j + 2 * t) =
                    P{out[i][j][0], out[i][j][1]};
          }
        }
      }
      // Y[k] to the producer (its next row's Y chunks read it); Cs is
      // rewritten by the next row
      if (k + 1 < nb) bar_arrive(2, THREADS);
      bar_sync(1, CONSUMERS);
    }
  }
  // no block leaves while a multicast or an arrival may still reach it
  cluster_sync();
}

// Grid: blocks (g * S + s) * c + rank for stripe group g (c column tiles,
// one bm stripe when c > 1), subdomain s and cluster rank; a cluster is c
// consecutive blocks, and the groups, whose starts are non-decreasing, go
// in order.
template <class T, int KC, int PASSES>
__global__ void __launch_bounds__(THREADS, (blocks_per_sm<KC, PASSES>()))
stepped_trsm_cluster_kernel(const __grid_constant__ CUtensorMap fmap,
                            const __grid_constant__ CUtensorMap lmap,
                            const int* __restrict__ rowptr,
                            const int* __restrict__ colidx,
                            const T* __restrict__ B,
                            const int* __restrict__ start_block,
                            T* __restrict__ Y, int S, int n, int m, int bs,
                            int bm, int n_blocks, int cluster) {
  static_assert(std::is_same<T, float>::value, "the f32 packed TRSM");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  float* smem = reinterpret_cast<float*>(
      smem_raw + (((raw + SWIZZLE_ALIGN - 1) & ~(uint32_t)(SWIZZLE_ALIGN - 1)) -
                  raw));
  const int rank = (int)cluster_rank();
  const int group = (int)(blockIdx.x / (unsigned)(S * cluster));
  const int col0 = (group * cluster + rank) * TN;
  const int64_t s = (blockIdx.x / (unsigned)cluster) % (unsigned)S;
  const int start = min(start_block[col0 / bm], n / bs);
  const PackedFactor<float> fac{nullptr, rowptr, colidx, n_blocks};
  solve_cluster_tile<KC, PASSES>(&fmap, &lmap, fac, B, Y, s, col0, start, n,
                                 m, bs, n_blocks, cluster, rank, smem);
}

// cuTensorMapEncodeTiled, which libcuda exports, fetched through the
// runtime (this library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (rows, bs) f32 matrix at base in boxes of KC columns x min(bs, ROWS)
// rows, swizzled over the box's KC * 4 bytes; returns 0 or an error code
template <int KC>
int chunk_map(CUtensorMap* map, const float* base, int64_t rows, int bs) {
  static_assert(KC == 8 || KC == 16 || KC == 32, "a 32B, 64B or 128B row");
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)bs, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)bs * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)std::min(bs, ROWS)};
  const cuuint32_t elems[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = KC == 32   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : KC == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// the launch configuration of an instance: its grid of `tiles` x S blocks
// in clusters of `cluster`, its shared memory, on `stream`
template <class Kernel>
void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2],
                   Kernel*, size_t smem, int blocks, int cluster,
                   cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = CLUSTER_POLICY;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
}

template <int KC, int PASSES>
int launch_kc(const float* values, const int* rowptr, const int* colidx,
              int n_blocks, const float* Linv, const float* B,
              const int* start_block, float* Y, int S, int n, int m, int bs,
              int bm, cudaStream_t stream) {
  auto kernel = stepped_trsm_cluster_kernel<float, KC, PASSES>;
  constexpr size_t smem = smem_bytes<KC, PASSES>();
  cudaError_t err = dmma::set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int cluster = cluster_tiles(bm);
  const int tiles = (m + TN - 1) / TN;
  if (tiles % cluster) return (int)cudaErrorInvalidValue;
  CUtensorMap fmap, lmap;
  int e = chunk_map<KC>(&fmap, values, (int64_t)S * n_blocks * bs, bs);
  if (!e) e = chunk_map<KC>(&lmap, Linv, (int64_t)S * n, bs);
  if (e) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  launch_config(cfg, attr, kernel, smem, tiles * S, cluster, stream);
  int clusters = 0;  // a cluster that does not fit the card is refused
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, fmap, lmap, rowptr, colidx, B,
                           start_block, Y, S, n, m, bs, bm, n_blocks, cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// *clusters: the clusters of `cluster` blocks of the instance bs takes that
// the card holds at once (cudaOccupancyMaxActiveClusters)
template <int KC, int PASSES>
int resident_kc(int cluster, int* clusters) {
  auto kernel = stepped_trsm_cluster_kernel<float, KC, PASSES>;
  constexpr size_t smem = smem_bytes<KC, PASSES>();
  cudaError_t err = dmma::set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  launch_config(cfg, attr, kernel, smem, 8 * cluster, cluster, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// f(integral_constant KC, integral_constant PASSES) for the instance bs
// takes: chunks MAX_KC deep where that divides bs, else 16, else 8;
// row_passes(bs) passes
template <class F>
int with_instance(int bs, F&& f) {
  using std::integral_constant;
  auto with_passes = [&](auto kc) {
    return stepped::row_passes(bs) == 1 ? f(kc, integral_constant<int, 1>())
                                        : f(kc, integral_constant<int, 2>());
  };
  if (bs % MAX_KC == 0) return with_passes(integral_constant<int, MAX_KC>());
  if (bs % 16 == 0) return with_passes(integral_constant<int, 16>());
  return with_passes(integral_constant<int, 8>());
}

// The packed f32 TRSM for 24 <= bs <= 256 (a multiple of 8), any bm a
// multiple of 8.
inline int launch(const float* values, const int* rowptr, const int* colidx,
                  int n_blocks, const float* Linv, const float* B,
                  const int* start_block, float* Y, int S, int n, int m,
                  int bs, int bm, cudaStream_t stream) {
  return with_instance(bs, [&](auto kc, auto passes) {
    return launch_kc<decltype(kc)::value, decltype(passes)::value>(
        values, rowptr, colidx, n_blocks, Linv, B, start_block, Y, S, n, m,
        bs, bm, stream);
  });
}

inline int resident(int bs, int cluster, int* clusters) {
  return with_instance(bs, [&](auto kc, auto passes) {
    return resident_kc<decltype(kc)::value, decltype(passes)::value>(
        cluster, clusters);
  });
}

}  // namespace trsm_cluster
