// Hand-written Hopper (sm_90a) kernels for KMeans' bf16 stats round
// (flink_ml_tpu_torch/ops/kmeans.py: kmeans_update_stats(...,
// compute_dtype=torch.bfloat16)), at every (k, d): one fused pass for
// k <= 256 and d <= 64 (below), two passes past it (the second part of
// this note).
//
// Replaces the Pallas kernel _stats_kernel(tie_policy, jnp.bfloat16) of
// flink_ml_tpu/ops/kmeans_pallas.py (kmeans_update_stats, :300-330).  The
// function is the JAX kernel's: points and centroids rounded to bf16 (to
// nearest even) for the score product, whose sums are f32; the score
// -2 * dot + |c|^2 with |c|^2 in f32 from the un-rounded centroids; first
// (lowest tied index), fast (every index equal to the row minimum) or
// split (1/#ties to each); sums += bf16(share) * bf16(p), counts += the
// f32 share.
//
// Bound on the H100 at the headline (n = 2^20, d = 64, k = 256): the f32
// points read once, 268 MB, take 0.080 ms at 3.35 TB/s; the score product
// (3.4e10 FLOPs) and the one-hot sums product (as many) take 0.035 ms each
// at the 989 TFLOP/s of the bf16 tensor cores.  So the kernel is bound by
// bytes, and its design keeps everything but the points' one read on chip:
//
// - One block per SM walks tiles of 128 points (b, b + G, ...).  In a
//   producer warpgroup one thread keeps a ring of up to 4 f32 tiles in
//   flight with 1-D bulk copies (cp.async.bulk, the TMA engine; a tile of
//   128 rows is contiguous in device memory) completing on mbarriers, and
//   three warps convert each tile once into a bf16 tile in shared memory,
//   in the 128-byte swizzled layout wgmma reads.
// - Two consumer warpgroups each take 64 points of a tile and score them
//   on wgmma (m64n128k16, one product of 128
//   centroids at a time, A = the points, B = the centroids resident as bf16
//   for the block's life, both K-major).  A point's score row lies in one
//   quad of lanes: its minimum comes by quad shuffles, and each lane's bits
//   of the centroids that attain it are the sign bits of m - s shifted in
//   one at a time.  A product whose minimum is above the best so far keeps
//   no bits, one below it clears the earlier products' bits.  Nothing is
//   rescored: duplicated centroids are identical B columns and score
//   bit-identically, and zero pad rows score |c|^2 exactly.
// - Each lane stores its bit words to shared memory as the point's mask,
//   with the point's share: first keeps the lowest tied index, fast every
//   tied one with share 1, split every one with share 1/#ties.
// - Then the group sums the tile before (both groups' points) for its
//   64-cluster blocks w and w + 2: sums (k x d) += S^T . bf16(P) on wgmma
//   (m64n64k16), S^T's A fragments built in registers from the masks, B
//   the bf16 tile read MN-major.  Its (k, d) partial stays in registers
//   across all of the block's tiles and is written once.  Counts add the
//   f32 shares from the same masks.  The warps meet only through mbarriers
//   (a tile converted; scored by both groups; summed by both), so one
//   group's products run beside the other's epilogue and the conversion.
// - |c|^2 is computed in the prologue, fmaf over ascending dims (the bits
//   of kmeans.cu's centroid_norms_kernel).  A second small kernel sums the
//   blocks' partials in a fixed order.  No atomics: two launches give the
//   same bits.
// - Rows past n are masked; zero pad rows are scored like any row (the
//   caller's pad_correction removes them).  A tile that is not whole, or
//   points whose base is not 16-byte aligned, are read by the converters
//   from device memory.
//
// The plan: the producer warpgroup gives up registers (setmaxnreg) so a
// consumer thread has 232; it holds its partial (2 cluster blocks x 32
// floats for d <= 64) beside a product's 64 scores, where a d <= 128
// partial spilled.  Shared memory holds the bf16 centroids (32 KB at
// k 256), three bf16 tiles with their masks, and the ring, within the
// 227 KB a block may have.
//
// Past k 256 or d 64 the fused plan does not hold: a block's (k, d)
// partial outgrows the consumers' registers and the bf16 centroids its
// shared memory.  The two-pass path splits the round where that costs no
// rescore on the common path (ops/kmeans.py::bf16_plan chooses the route
// and the chunks a scoring launch takes; make_plan and make_wide_plan lay
// the plan out and refuse one that does not fit):
//
// - pack: the centroids (and the points, where the first scoring launch
//   cannot) into bf16 panels in device memory, a panel 128 rows x 64 dims
//   in the swizzled layout wgmma reads (16 KB, one bulk copy); d padded to
//   whole panels with zeros, k to whole 128-centroid chunks of zero rows
//   whose |c|^2 is +inf.  |c|^2 as the fused pass computes it.
// - scoring: persistent blocks walk tiles of 128 points; each consumer
//   warpgroup scores its 64 rows a chunk at a time (m64n128k16 over the
//   panels in ascending order), each lane keeping over its own columns the
//   least score, the lowest index at it and how many equal it (the sign
//   bits of m - s), and the quad merges its lanes once a tile.  Up to 4
//   panels (d <= 256) a launch's chunks are held in shared memory (13
//   panels less two tiles of ring: 9 chunks at d 64, 3 at d 128, 11 below
//   d 64) and the producer brings a tile's panels; past that every
//   (points, centroids) panel pair streams through a ring of 12.  At d 64
//   and 128 the first launch reads the f32 rows itself (bulk copies into
//   up to 6 pieces of 16 KB), its three converter warps write the bf16
//   panels into the ring slots and one of them bulk-stores each tile's
//   panels for the other passes, so the pack's bytes overlap the scoring.
//   Chunks past a launch's go to further launches in chunk order, each
//   merging into the row state (m, index, count) of those before: an equal
//   minimum keeps the earlier, lower index and adds the counts, so "first"
//   is global and the counts exact.  The last launch flags the tiles with
//   a tied row.
// - sums: one launch, a job per (256-cluster slab, 64-dim panel), each on
//   `reps` blocks over strided tiles (the blocks of one stride start
//   together, so a tile's panel comes from HBM about once and from L2 for
//   the other jobs).  A tile's panel comes with its rows' indices; where
//   each row counts once (every tile under first, an unflagged one under
//   fast or split) S^T's one-hot fragments are built from the indices; a
//   flagged tile rescores the slab's chunks by the same wgmma sequence
//   (the same bits) and masks the scores equal to each row's minimum
//   (shares 1 or 1/count) for the fused pass's sums.  A job's (256 x 64)
//   partial stays in registers, written once; a last small kernel adds
//   each job's partials in rank order.  No atomics: two launches give the
//   same bits.
//
// Bounds (989 TFLOP/s bf16, 3.35 TB/s): (2^20, 64, k 1024) 0.139 ms, the
// score product (0.278 with the one-hot sums product; bytes 0.080);
// (2^20, 128, k 256) 0.160, the f32 points read once (products 0.069 and
// 0.139); (2^18, 64, k 4096) 0.139 (0.278; bytes 0.021).  On the H100
// (PERF.md row 4, 700 W) the path takes 0.95-0.98, 0.58-0.59 and
// 0.99-1.02 ms there, 3.8x, 1.7x and 3.7x under bf16 addmm of the score
// product: what bounds it is the CUDA cores' scoring epilogue (~0.39 ms
// at k 1024: four instructions a score, two consumer warps a scheduler)
// and the sums jobs' k/256 one-hot products with their fragments (~0.33
// ms), scripts/kmeans_bf16_phase_times.py --wide.  168 registers at
// entry (the consumers 232 by setmaxnreg; 8 bytes of spill in the
// scoring kernel, none elsewhere); dynamic shared memory: scoring 218,248
// bytes at d 64 (k 1024, 4096), 215,208 at d 128, 200,488 streamed
// (d 300, k 600); sums 213,696.
//
// Against kmeans.cu's bf16 modes, the route these shapes took before:
// both products are wgmma (there first on mma.sync, fast and split on
// the CUDA cores); a launch's centroids are staged once a block (there a
// 256-centroid slab 64 dims at a time each tile) and the points read
// once into bf16 panels (there lanes read device memory past the tile's
// budget); the keyed reduce is a one-hot wgmma (there warp c % 8 added
// its rows on the CUDA cores); producer and consumers meet on mbarriers
// with bulk copies in flight (there one 256-thread block with cp.async
// and __syncthreads).
//
// Each launcher returns cudaGetLastError() so the caller sees a refused
// launch.  A thread that waits on a barrier for ~20 s traps (a launch
// failure the wrapper raises) rather than hang.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128; // and a producer warpgroup,
constexpr int kConverters = 96;            // whose warps 1-3 convert
constexpr int kTile = 128;                 // points per tile (64 a group)
constexpr int kTileBytes = kTile * 128;    // a bf16 tile: 64 dims a row
constexpr int kMaxK = 256;
constexpr int kMaxD = 64;
constexpr int kBufs = 3;                   // bf16 tiles in turn
constexpr int kMaxStages = 4;              // f32 tiles in flight
constexpr int kCopyPiece = 16384;          // bytes per bulk copy
constexpr size_t kSmemLimit = 232448;      // 227 KB, Hopper's opt-in
constexpr long long kHangCycles = 1ll << 35;

enum Policy { kFirst = 0, kFast = 1, kSplit = 2 };

// Byte offsets of the shared-memory areas from the 1024-aligned base (the
// bf16 centroids first).
struct Plan {
  int kp;       // centroid rows held: 128 or 256 (whole score products)
  int words;    // 32-bit mask words of a point (kp / 32)
  int stages;   // f32 tiles in flight
  int off_tile, off_mask, off_wf, off_wb, off_c2, off_bar, off_ring;
  size_t smem;  // bytes to request (+1024 of alignment slack)
};

// mbarriers: full and empty a ring slot; converted, ready (scored) and
// free a bf16 tile; then a tied-row flag a bf16 tile and warpgroup
constexpr int kBarBytes = (2 * kMaxStages + 3 * kBufs) * 8 + 2 * kBufs * 4;

// The fused pass's layout for (k, d) with `products` score products of 128
// centroids a tile; false where it does not hold the shape.
bool make_plan(int k, int d, int products, Plan* p) {
  if (k < 1 || d < 1 || k > kMaxK || d > kMaxD || products < 1 ||
      k > products * 128 || products * 128 > kMaxK)
    return false;
  p->kp = products * 128;
  p->words = p->kp / 32;
  int off = p->kp * 128;                  // bf16 centroids
  p->off_tile = off;
  off += kBufs * kTileBytes;
  p->off_mask = off;
  off += kBufs * p->words * kTile * 4;    // their masks
  p->off_wf = off;
  off += kBufs * kTile * 4;               // f32 shares
  p->off_wb = off;
  off += kBufs * kTile * 2;               // bf16 shares
  p->off_c2 = off;
  off += p->kp * 4;
  p->off_bar = off;
  off += kBarBytes;
  off = (off + 127) / 128 * 128;
  p->off_ring = off;
  const size_t tile_f32 = static_cast<size_t>(kTile) * d * 4;
  size_t stages = (kSmemLimit - 1024 - off) / tile_f32;
  if (stages > kMaxStages) stages = kMaxStages;
  p->stages = static_cast<int>(stages);
  p->smem = off + stages * tile_f32 + 1024;
  return stages >= 1;
}

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, bulk copies, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival for the calling warp, once all its lanes are done with what
// the barrier guards (the consumers' barriers count warps).
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete; trap after ~20 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > kHangCycles)
      __trap();
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on bar's transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed group of this warpgroup is done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define KB_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128) (+)= A (64 x 16) . B (16 x 128), both from shared memory,
// K-major; scale_d 0 overwrites d.  d[4 j + e]: row 16 w + g (+8 for e >=
// 2), column 8 j + 2 q + (e & 1) (w the warp of the group, g = lane / 4,
// q = lane % 4).
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : KB_F8(d, 0), KB_F8(d, 8), KB_F8(d, 16), KB_F8(d, 24), KB_F8(d, 32),
        KB_F8(d, 40), KB_F8(d, 48), KB_F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) (+)= A (64 x 16, registers, mma.sync's A layout per warp:
// a0 (g, 2q..2q+1), a1 (g+8, ..), a2 (g, 2q+8..), a3 (g+8, 2q+8..)) .
// B (16 x 64 from shared memory, MN-major); d as in wgmma_n128_ss.
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : KB_F8(d, 0), KB_F8(d, 8), KB_F8(d, 16), KB_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// Two floats as one bf16 pair (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte of dim j (even) of row r in a bf16 tile: 64 dims a 128-byte row,
// 16-byte group j / 8 at (j / 8) ^ (r % 8): the 128-byte swizzle of the
// 8-row atoms that wgmma reads (atoms 1024-byte aligned).
__device__ __forceinline__ int tile_byte(int r, int j) {
  return r * 128 + ((((j >> 3) ^ r) & 7) << 4) + ((j & 7) << 1);
}

// Rows of `rows` valid f32 values of width d (row r at src + r * d, generic
// pointer: device memory, or a ring slot that is not 16-byte aligned) into
// nrows bf16 rows, zero past `rows` and past d.
template <int STEP>
__device__ __forceinline__ void to_bf16_rows(uint8_t* dst, const float* src,
                                             int rows, int nrows, int d,
                                             int t) {
  const bool vec =
      (d & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int item = t; item < nrows * 8; item += STEP) {
    const int r = item >> 3;
    const int j0 = (item & 7) * 8;
    const float* row = src + static_cast<size_t>(r) * d;
    float v[8];
    if (vec) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y = x;
      if (r < rows && j0 < d) {
        x = *reinterpret_cast<const float4*>(row + j0);
        y = *reinterpret_cast<const float4*>(row + j0 + 4);
      }
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = r < rows && j0 + e < d ? row[j0 + e] : 0.0f;
    }
    *reinterpret_cast<uint4*>(dst + tile_byte(r, j0)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// A whole f32 tile in the shared ring, for d % 4 == 0, by `lanes`
// threads: a thread converts 4 dims (one 16-byte shared load,
// conflict-free across a warp) into their 8 bytes of the swizzled row; row
// and dim step on without a division.  Dims past d stay as the prologue
// zeroed them.
__device__ __forceinline__ void ring_to_bf16(uint8_t* dst, const float* src,
                                             int d, int t, int lanes) {
  const int quads = kTile * d / 4;
  const int step_r = 4 * lanes / d;
  const int step_j = 4 * lanes - step_r * d;
  int r = 4 * t / d;
  int j = 4 * t - r * d;
#pragma unroll 4
  for (int x = t; x < quads; x += lanes) {
    const float4 v = reinterpret_cast<const float4*>(src)[x];
    *reinterpret_cast<uint2*>(dst + tile_byte(r, j)) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    r += step_r;
    j += step_j;
    if (j >= d) {
      j -= d;
      ++r;
    }
  }
}

// ---------------------------------------------------------------------------
// the score product
// ---------------------------------------------------------------------------

// The mask layout.  Centroid c's bit for a point: c = 128 s + 8 j + 2 q +
// b (j < 16, q < 4, b < 2) is bit 2 j + b of word 4 s + q, so quad lane q
// holds whole words (its columns of the score fragments) and stores them
// itself.

// One product of 128 centroids (chunk sc) for this warpgroup's 64 points:
// m[h], the minimum of point h (16 w + g + 8 h) over the chunk, and eq[h],
// this lane's bits of the centroids that attain it (bit 2 j + b for
// centroid 128 sc + 8 j + 2 q + b).  Scores are -2 * dot + |c|^2 in one
// fmaf (-2 * dot is exact, so it rounds as score_of's two roundings do).
// A score s is never below the minimum m, and never -0, so s == m exactly
// where m - s is +0: the sign bits of m - s, shifted in one at a time, are
// the lane's bits of s > m.
__device__ __forceinline__ void score_chunk(uint32_t a_base, uint32_t b_base,
                                            const float* c2s, int sc, int q,
                                            float (&m)[2],
                                            uint32_t (&eq)[2]) {
  const float inf = __int_as_float(0x7f800000);
  // no zero fill (an instruction writing an accumulator inside a product's
  // stage serialises every wgmma): the first step overwrites (scale-d 0)
  float acc[64];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_n128_ss(acc, desc_sw128(a_base + ks * 32, 16, 1024),
                  desc_sw128(b_base + sc * 128 * 128 + ks * 32, 16, 1024),
                  ks > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  // acc[4 j + e]: point h = e / 2, centroid 128 sc + 8 j + 2 q + e % 2;
  // minima in 4 independent chains a point
  float mm[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) mm[h][c] = inf;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 cc =
        *reinterpret_cast<const float2*>(c2s + sc * 128 + 8 * j + 2 * q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = fmaf(-2.0f, acc[4 * j + e], (e & 1) ? cc.y : cc.x);
      acc[4 * j + e] = v;
      mm[e >> 1][(2 * j + e) & 3] = fminf(mm[e >> 1][(2 * j + e) & 3], v);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = fminf(fminf(mm[h][0], mm[h][1]), fminf(mm[h][2], mm[h][3]));
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    m[h] = fminf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    uint32_t above = 0u;  // bit 2 j + b: the score is above the minimum
#pragma unroll
    for (int j = 15; j >= 0; --j)
#pragma unroll
      for (int b = 1; b >= 0; --b)
        above = __funnelshift_l(__float_as_uint(m[h] - acc[4 * j + 2 * h + b]),
                                above, 1);
    eq[h] = ~above;
  }
}

// Scores of this warpgroup's 64 points against the held centroids, their
// minimum, tie set and share; writes the masks (masks[u * kTile + p] for
// word u, the layout above) and the shares, and flags a tied row.
template <int POLICY>
__device__ __forceinline__ void score_tile(
    const uint8_t* tb, const uint8_t* cent_s, const float* c2s,
    uint32_t* masks, float* wf, uint16_t* wb, int* tied, int k, int wg,
    int wi, int g, int q, size_t row0, int n) {
  const uint32_t a_base = smem_u32(tb) + wg * 64 * 128;
  const uint32_t b_base = smem_u32(cent_s);
  const int nchunks = (k + 127) / 128;
  float best[2];
  uint32_t bits[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
  for (int sc = 0; sc < 2; ++sc) {
    if (sc >= nchunks) break;
    float m[2];
    uint32_t eq[2];
    score_chunk(a_base, b_base, c2s, sc, q, m, eq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (sc == 0 || m[h] < best[h]) {
        bits[h][0] = 0u;
        best[h] = m[h];
      } else if (m[h] > best[h]) {
        eq[h] = 0u;
      }
      bits[h][sc] = eq[h];
    }
  }
  int nt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int x = __popc(bits[h][0]) + __popc(bits[h][1]);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    nt[h] = x + __shfl_xor_sync(0xffffffffu, x, 2);
  }
  if (POLICY == kFirst && __any_sync(0xffffffffu, nt[0] > 1 || nt[1] > 1)) {
    // the lowest tied index: each lane's lowest, the quad's least kept
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int lo = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t x = bits[h][c];
        if (x) {
          const int bit = __ffs(x) - 1;
          lo = min(lo, c * 128 + 8 * (bit >> 1) + 2 * q + (bit & 1));
        }
      }
      int w = min(lo, __shfl_xor_sync(0xffffffffu, lo, 1));
      w = min(w, __shfl_xor_sync(0xffffffffu, w, 2));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int at = w - c * 128 - 2 * q;  // 8 j + b in this lane's word
        bits[h][c] = at >= 0 && at < 128 && (at & 7) < 2
                         ? 1u << (2 * (at >> 3) + (at & 1))
                         : 0u;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = wg * 64 + 16 * wi + g + 8 * h;
    const bool valid = row0 + p < static_cast<size_t>(n);
    if (POLICY == kSplit && valid && nt[h] > 1) *tied = 1;
    const float share =
        POLICY == kSplit ? 1.0f / static_cast<float>(nt[h]) : 1.0f;
    masks[q * kTile + p] = valid ? bits[h][0] : 0u;
    if (nchunks > 1) masks[(4 + q) * kTile + p] = valid ? bits[h][1] : 0u;
    if (q == 0) {
      wf[p] = valid ? share : 0.0f;
      wb[p] = valid ? __bfloat16_as_ushort(__float2bfloat16_rn(share)) : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// the sums product
// ---------------------------------------------------------------------------

// Bits `bit` and `bit + 2` of the mask words of points a and b, as two
// pairs: lo = bit of a at bit 0 and of b at bit 16, hi the same two above;
// times 0xffff, the halves of an A register where the share enters.
__device__ __forceinline__ void pair_bits(uint32_t a, uint32_t b, int bit,
                                          uint32_t& lo, uint32_t& hi) {
  const uint32_t z = __byte_perm(a >> bit, b >> bit, 0x5410);
  lo = z & 0x10001u;
  hi = (z >> 2) & 0x10001u;
}

// S^T's A fragments of one 64-cluster block (rows mb * 64 + 16 w + g and
// + 8) and its counts.  Where every share is 1 (first, fast, and split on
// a tile without a tied row: bf16 0x3f80) a fragment is the pair's bits
// times 0x3f80 and the counts are integers, tallied from the same bits;
// otherwise (split) the bf16 shares are masked in and the f32 shares
// added one by one.
template <bool kOnes>
__device__ __forceinline__ void share_fragments(
    const uint32_t* masks, const float* wf, const uint16_t* wb, int mb,
    int wi, int g, int q, uint32_t (&a)[8][4], float (&cnt)[2]) {
  // clusters c0 = 64 mb + 16 wi + g and c0 + 8: word 4 (mb / 2) + (g / 2)
  // % 4, bits 16 (mb % 2) + 4 wi + g % 2 and two above (the mask layout)
  const uint32_t* mrow = masks + (4 * (mb >> 1) + ((g >> 1) & 3)) * kTile;
  const int b0 = 16 * (mb & 1) + 4 * wi + (g & 1);
  uint32_t tally[2] = {0u, 0u};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int pa = 16 * ks + 2 * q;
    const uint2 mlo = *reinterpret_cast<const uint2*>(mrow + pa);
    const uint2 mhi = *reinterpret_cast<const uint2*>(mrow + pa + 8);
    uint32_t t[4];
    pair_bits(mlo.x, mlo.y, b0, t[0], t[1]);
    pair_bits(mhi.x, mhi.y, b0, t[2], t[3]);
    if (kOnes) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[ks][e] = t[e] * 0x3f80u;
      tally[0] += t[0] + t[2];
      tally[1] += t[1] + t[3];
    } else {
      const uint32_t slo = *reinterpret_cast<const uint32_t*>(wb + pa);
      const uint32_t shi = *reinterpret_cast<const uint32_t*>(wb + pa + 8);
      const float2 flo = *reinterpret_cast<const float2*>(wf + pa);
      const float2 fhi = *reinterpret_cast<const float2*>(wf + pa + 8);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[ks][e] = (t[e] * 0xffffu) & (e < 2 ? slo : shi);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cnt[h] += (t[h] & 1u) ? flo.x : 0.0f;
        cnt[h] += (t[h] >> 16) ? flo.y : 0.0f;
        cnt[h] += (t[h + 2] & 1u) ? fhi.x : 0.0f;
        cnt[h] += (t[h + 2] >> 16) ? fhi.y : 0.0f;
      }
    }
  }
  if (kOnes) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cnt[h] += static_cast<float>((tally[h] & 0xffffu) + (tally[h] >> 16));
  }
}

// acc += S^T . bf16(P) over the tile's 128 points (8 steps of 16, one
// m64n64k16 each) for one cluster block; `first` (the block's first tile)
// overwrites acc.
__device__ __forceinline__ void sums_product(uint32_t t_base,
                                             const uint32_t (&a)[8][4],
                                             float (&acc)[32], bool first) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_n64_rs(acc, a[ks], desc_sw128(t_base + ks * 16 * 128, 1024, 1024),
                 !(first && ks == 0));
  wgmma_commit();
}

// sums += S^T . bf16(P) for this warpgroup's cluster blocks (w, w + 2) and
// counts += the shares; the second block's fragments are built while the
// first block's product runs.
template <bool kOnes>
__device__ __forceinline__ void sums_blocks(
    uint32_t t_base, const uint32_t* masks, const float* wf,
    const uint16_t* wb, float (&acc)[2][32], float (&cnt)[2][2], bool first,
    int nmb, int wg, int wi, int g, int q) {
  // no instruction may touch an accumulator while a product runs
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  uint32_t a0[8][4];
  share_fragments<kOnes>(masks, wf, wb, wg, wi, g, q, a0, cnt[0]);
  sums_product(t_base, a0, acc[0], first);
  if (wg + 2 < nmb) {
    uint32_t a1[8][4];
    share_fragments<kOnes>(masks, wf, wb, wg + 2, wi, g, q, a1, cnt[1]);
    sums_product(t_base, a1, acc[1], first);
  }
  wgmma_wait_all();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// The consumers' step of tile j (the block's j-th): once both warpgroups
// have scored it, sums and counts of its points for this group's cluster
// blocks; then the tile's buffer is free.  tied: the tile's two flags.
template <int POLICY>
__device__ __forceinline__ void sums_step(
    int j, const uint8_t* tiles, const uint32_t* masks, const float* wf,
    const uint16_t* wb, const int* tied, uint64_t* ready, uint64_t* freeb,
    int words, float (&acc)[2][32], float (&cnt)[2][2], int nmb, int wg,
    int wi, int g, int q) {
  const int b = j % kBufs;
  mbar_wait(ready + b, (j / kBufs) & 1);
  if (wg < nmb) {
    const uint32_t t_base = smem_u32(tiles + b * kTileBytes);
    const uint32_t* mk = masks + b * words * kTile;
    if (POLICY != kSplit || (tied[2 * b] | tied[2 * b + 1]) == 0)
      sums_blocks<true>(t_base, mk, wf + b * kTile, wb + b * kTile, acc, cnt,
                        j == 0, nmb, wg, wi, g, q);
    else
      sums_blocks<false>(t_base, mk, wf + b * kTile, wb + b * kTile, acc,
                         cnt, j == 0, nmb, wg, wi, g, q);
  }
  warp_arrive(freeb + b);
}

// The producer warpgroup's converter warps (1-3): each tile of the block
// into bf16 tile i % kBufs once both consumer groups have summed the tile
// it held, from the ring slot (then released) or, for a tile that is not
// whole or a base that is not 16-byte aligned, from device memory.
__device__ __forceinline__ void convert(const float* __restrict__ points,
                                        int n, int d, const Plan& plan,
                                        int bulk, uint8_t* tiles,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* converted, uint64_t* freeb,
                                        const float* ring, int t) {
  const int ntiles = (n + kTile - 1) / kTile;
  int i = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
    const int b = i % kBufs;
    mbar_wait(freeb + b, ((i / kBufs) & 1) ^ 1);
    const size_t row0 = static_cast<size_t>(tile) * kTile;
    const int rows = min(kTile, n - static_cast<int>(row0));
    const bool from_ring = bulk && rows == kTile;
    const int s = i % plan.stages;
    const float* slot = ring + static_cast<size_t>(s) * kTile * d;
    if (from_ring) mbar_wait(full + s, (i / plan.stages) & 1);
    uint8_t* tb = tiles + b * kTileBytes;
    if (from_ring && (d & 3) == 0)
      ring_to_bf16(tb, slot, d, t, kConverters);
    else
      to_bf16_rows<kConverters>(tb, from_ring ? slot : points + row0 * d,
                                rows, kTile, d, t);
    if (from_ring) warp_arrive(empty + s);
    fence_proxy_async();
    warp_arrive(converted + b);
  }
}

// The consumer warpgroups: each scores its half of tile i, then sums tile
// i - 1, whose other half the other group scored.
template <int POLICY>
__device__ __forceinline__ void consume(
    float* __restrict__ partial, float* __restrict__ pcounts, int n, int k,
    int d, const Plan& plan, const uint8_t* cent_s, const uint8_t* tiles,
    uint32_t* masks, float* wf, uint16_t* wb, const float* c2s,
    uint64_t* converted, uint64_t* ready, uint64_t* freeb, int* tied) {
  const int tid = threadIdx.x;
  const int ntiles = (n + kTile - 1) / kTile;
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int wi = wt >> 5;
  const int g = (tid & 31) >> 2;
  const int q = tid & 3;
  const int nmb = (k + 63) / 64;
  // the partial: the block's first tile overwrites it (scale-d 0)
  float acc[2][32];
  float cnt[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  int i = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
    const int b = i % kBufs;
    mbar_wait(converted + b, (i / kBufs) & 1);
    // the flag's last readers summed tile i - kBufs before it converted
    if (wt == 0) tied[2 * b + wg] = 0;
    score_tile<POLICY>(tiles + b * kTileBytes, cent_s, c2s,
                       masks + b * plan.words * kTile, wf + b * kTile,
                       wb + b * kTile, tied + 2 * b + wg, k, wg, wi, g, q,
                       static_cast<size_t>(tile) * kTile, n);
    warp_arrive(ready + b);
    if (i > 0)
      sums_step<POLICY>(i - 1, tiles, masks, wf, wb, tied, ready, freeb,
                        plan.words, acc, cnt, nmb, wg, wi, g, q);
  }
  if (i > 0)
    sums_step<POLICY>(i - 1, tiles, masks, wf, wb, tied, ready, freeb,
                      plan.words, acc, cnt, nmb, wg, wi, g, q);
  // the block's partial, written once
  float* my_part = partial + static_cast<size_t>(blockIdx.x) * k * d;
  float* my_cnt = pcounts + static_cast<size_t>(blockIdx.x) * k;
#pragma unroll
  for (int mbi = 0; mbi < 2; ++mbi) {
    const int mb = 2 * mbi + wg;
    if (mb >= nmb) break;
    const int c0 = mb * 64 + 16 * wi + g;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int c = c0 + 8 * ((r >> 1) & 1);
      const int j = 8 * (r >> 2) + 2 * q + (r & 1);
      if (c < k && j < d) my_part[static_cast<size_t>(c) * d + j] = acc[mbi][r];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = cnt[mbi][h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int c = c0 + 8 * h;
      if (q == 0 && c < k) my_cnt[c] = x;
    }
  }
}

template <int POLICY>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_bf16_kernel(const float* __restrict__ points,
                   const float* __restrict__ cent, float* __restrict__ partial,
                   float* __restrict__ pcounts, int n, int k, int d, Plan plan,
                   int bulk) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1024-byte aligned (the swizzle atoms) by an offset into the array, so
  // the compiler keeps every access below in the shared space (LDS/STS)
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* cent_s = smem;
  uint8_t* tiles = smem + plan.off_tile;
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + plan.off_mask);
  float* wf = reinterpret_cast<float*>(smem + plan.off_wf);
  uint16_t* wb = reinterpret_cast<uint16_t*>(smem + plan.off_wb);
  float* c2s = reinterpret_cast<float*>(smem + plan.off_c2);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  uint64_t* empty = full + kMaxStages;
  uint64_t* converted = empty + kMaxStages;
  uint64_t* ready = converted + kBufs;
  uint64_t* freeb = ready + kBufs;
  int* tied = reinterpret_cast<int*>(freeb + kBufs);
  float* ring = reinterpret_cast<float*>(smem + plan.off_ring);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConverters / 32);
    }
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(converted + b, kConverters / 32);
      mbar_init(ready + b, kConsumers / 32);
      mbar_init(freeb + b, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  to_bf16_rows<kThreads>(cent_s, cent, k, plan.kp, d, tid);
  // the bf16 tiles start zero: the ring's conversion writes dims < d only
  for (int x = tid; x < kBufs * kTileBytes / 16; x += kThreads)
    reinterpret_cast<uint4*>(tiles)[x] = make_uint4(0u, 0u, 0u, 0u);
  // |c|^2, fmaf over ascending dims (zero past d adds nothing); +inf past
  // k, never a minimum.  The loads of 16 dims go out together.
  for (int c = tid; c < plan.kp; c += kThreads) {
    float s = __int_as_float(0x7f800000);
    if (c < k) {
      const float* row = cent + static_cast<size_t>(c) * d;
      s = 0.0f;
      for (int j0 = 0; j0 < d; j0 += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = j0 + u < d ? row[j0 + u] : 0.0f;
#pragma unroll
        for (int u = 0; u < 16; ++u) s = fmaf(v[u], v[u], s);
      }
    }
    c2s[c] = s;
  }
  fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: it gives up registers to the consumers; one
    // thread keeps the ring full, warps 1-3 convert
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - kConsumers;
    if (pt >= 32) {
      convert(points, n, d, plan, bulk, tiles, full, empty, converted, freeb,
              ring, pt - 32);
    } else if (pt == 0 && bulk) {
      const int ntiles = (n + kTile - 1) / kTile;
      const uint32_t bytes = static_cast<uint32_t>(kTile) * d * 4;
      int i = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
        if (n - tile * kTile < kTile) break;  // the ragged last tile
        const int s = i % plan.stages;
        mbar_wait(empty + s, ((i / plan.stages) & 1) ^ 1);
        mbar_expect_tx(full + s, bytes);
        const uint8_t* src = reinterpret_cast<const uint8_t*>(
            points + static_cast<size_t>(tile) * kTile * d);
        uint8_t* dst = reinterpret_cast<uint8_t*>(
            ring + static_cast<size_t>(s) * kTile * d);
        for (uint32_t off = 0; off < bytes; off += kCopyPiece)
          bulk_copy(dst + off, src + off,
                    bytes - off < kCopyPiece ? bytes - off : kCopyPiece,
                    full + s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<POLICY>(partial, pcounts, n, k, d, plan, cent_s, tiles, masks, wf,
                    wb, c2s, converted, ready, freeb, tied);
  }
}

// sums and counts = the blocks' partials added in a fixed order: a block
// of 256 threads takes 32 outputs, its 8 warps each add the partials
// b = w, w + 8, ... of them in ascending b (coalesced rows), and one warp
// adds the 8 in warp order.
constexpr int kReduceOut = 32;
constexpr int kReduceParts = 8;

__global__ void __launch_bounds__(kReduceOut * kReduceParts)
reduce_partials_bf16(const float* __restrict__ partial,
                     const float* __restrict__ pcounts, int grid, int k,
                     int d, float* __restrict__ sums,
                     float* __restrict__ counts) {
  __shared__ float part[kReduceParts][kReduceOut];
  const int lane = threadIdx.x % kReduceOut;
  const int w = threadIdx.x / kReduceOut;
  const size_t kd = static_cast<size_t>(k) * d;
  const size_t i = static_cast<size_t>(blockIdx.x) * kReduceOut + lane;
  float s = 0.0f;
  if (i < kd) {
#pragma unroll 4
    for (int b = w; b < grid; b += kReduceParts)
      s += partial[static_cast<size_t>(b) * kd + i];
  } else if (i < kd + k) {
#pragma unroll 4
    for (int b = w; b < grid; b += kReduceParts)
      s += pcounts[static_cast<size_t>(b) * k + (i - kd)];
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0) {
    float t = 0.0f;
#pragma unroll
    for (int p = 0; p < kReduceParts; ++p) t += part[p][lane];
    if (i < kd)
      sums[i] = t;
    else if (i < kd + k)
      counts[i - kd] = t;
  }
}

// ---------------------------------------------------------------------------
// the two-pass path: every shape past the fused kernel's (k > 256 or d > 64)
// ---------------------------------------------------------------------------

constexpr int kPanel = kTileBytes;  // 128 rows x 64 dims of bf16, swizzled
constexpr int kScorePanels = 13;    // panels a score block holds (held
                                    // centroids and ring together)
constexpr int kHeldMaxPanels = 4;   // d <= 256: a launch's centroids held
constexpr int kF32Pieces = 6;       // at most, 16 KB pieces of f32 rows
                                    // where the first launch converts
constexpr int kRingSlots = 12;      // ring slots of the streamed scoring
                                    // and of the sums kernel
constexpr int kSlab = 256;          // clusters of a sums job (4 x 64)
constexpr int kMaskWords = kSlab / 32;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kAux = kTile * 4;     // a tile's row indices (int)

// The row state the scoring launches carry (arrays of ntiles * 128): the
// least score, the lowest index at it (-1 past n) and their count.
struct Rows {
  float* m;
  int* idx;
  int* cnt;
};

struct WidePlan {
  int panels;    // P: 64-dim panels of a row (d padded with zeros)
  int kchunks;   // 128-centroid chunks (k padded: zero rows, |c|^2 = inf)
  int held;      // 1: a score launch's chunks held in shared memory
  int converts;  // 1: d 64 or 128, the first scoring launch packs the points
  int pieces;    // its ring of 16 KB f32 pieces
  int cpl;       // chunks a score launch takes at most
  int launches;  // score launches, in chunk order
  int slots;     // ring slots (panels) of the score kernel
  int slabs;     // 256-cluster slabs of the sums kernel
  int jobs;      // slabs x panels: a sums job is one slab's 64 dims
  int off_c2, off_bar, off_f32;  // score kernel, from the held centroids
  int off_mask, off_wf, off_wb, off_aux, off_sbar;  // sums, ring at 0
  size_t smem_score, smem_sums;
};

// The two-pass layout for (k, d) with `cpl` chunks a scoring launch;
// false where it does not fit.
bool make_wide_plan(int k, int d, int cpl, WidePlan* p) {
  if (k < 1 || d < 1 || cpl < 1) return false;
  const int P = (d + 63) / 64;
  p->panels = P;
  p->kchunks = (k + 127) / 128;
  p->held = P <= kHeldMaxPanels;
  p->converts = d == 64 || d == 128;
  // held chunks need at least two tiles of bf16 slots beside them and,
  // converting, two f32 pieces; the converting launch's loads in flight
  // are its pieces, so what remains goes to them
  if (p->held && cpl * P + 2 * P + 2 * p->converts > kScorePanels)
    return false;
  p->cpl = cpl;
  p->launches = (p->kchunks + cpl - 1) / cpl;
  p->pieces = p->converts ? std::min(kScorePanels - p->cpl * P - 2 * P,
                                     kF32Pieces)
                          : 0;
  const int f32 = p->pieces;
  p->slots = p->held ? std::min(kScorePanels - p->cpl * P - f32, 8)
                     : kRingSlots;
  p->slabs = (k + kSlab - 1) / kSlab;
  p->jobs = p->slabs * P;
  size_t off = static_cast<size_t>(p->held ? p->cpl * P + p->slots
                                           : p->slots) * kPanel;
  p->off_f32 = static_cast<int>(off);
  off += static_cast<size_t>(f32) * kPanel;
  p->off_c2 = static_cast<int>(off);
  off += static_cast<size_t>(p->cpl) * 128 * 4;
  p->off_bar = static_cast<int>(off);
  off += (2 * p->slots + 1 + 2 * kF32Pieces) * 8;
  p->smem_score = off + 1024;
  off = static_cast<size_t>(kRingSlots) * kPanel;
  p->off_mask = static_cast<int>(off);
  off += 2 * kMaskWords * kTile * 4;
  p->off_wf = static_cast<int>(off);
  off += 2 * kTile * 4;
  p->off_wb = static_cast<int>(off);
  off += 2 * kTile * 2;
  p->off_aux = static_cast<int>(off);
  off += kRingSlots * kAux;
  p->off_sbar = static_cast<int>(off);
  off += 2 * kRingSlots * 8;
  p->smem_sums = off + 1024;
  return p->smem_score <= kSmemLimit && p->smem_sums <= kSmemLimit;
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The consumer warpgroups' named barrier (the producer takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A ring of 16 KB panels filled in one fixed sequence by the producer
// thread and read in the same sequence by both consumer warpgroups: push
// i waits until slot i % slots is free, take i until it has landed, and
// each consumer warp gives it back once (empty counts 8 arrivals).
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int slots;
  uint8_t* aux;  // kAux bytes a slot beside the panel (the sums kernel)

  __device__ __forceinline__ void push(uint32_t i, const uint8_t* src,
                                       const void* aux_src = nullptr) const {
    const int s = static_cast<int>(i % slots);
    mbar_wait(empty + s, ((i / slots) & 1) ^ 1);
    mbar_expect_tx(full + s, aux_src ? kPanel + kAux : kPanel);
    bulk_copy(base + static_cast<size_t>(s) * kPanel, src, kPanel, full + s);
    if (aux_src)
      bulk_copy(aux + s * kAux, aux_src, kAux, full + s);
  }
  __device__ __forceinline__ uint32_t take(uint32_t i) const {
    const int s = static_cast<int>(i % slots);
    mbar_wait(full + s, (i / slots) & 1);
    return smem_u32(base + static_cast<size_t>(s) * kPanel);
  }
  __device__ __forceinline__ void give(uint32_t i) const {
    warp_arrive(empty + i % slots);
  }
};

// fillers: the arrivals that fill a slot (1: the producer's bulk copy).
__device__ __forceinline__ void init_ring(const Ring& r, int fillers = 1) {
  for (int s = 0; s < r.slots; ++s) {
    mbar_init(r.full + s, fillers);
    mbar_init(r.empty + s, kConsumerWarps);
  }
}

// s (64 x 128) (+)= A . B over one 64-dim panel: four m64n128k16 products
// (A: this group's 64 rows, B: 128 centroids, both K-major, swizzled);
// `fresh` overwrites s.  Every score of the path, in both passes, is this
// sequence over the panels in ascending order, so a rescore gives the
// same bits.
__device__ __forceinline__ void panel_product(float (&s)[64], uint32_t a,
                                              uint32_t b, bool fresh) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_n128_ss(s, desc_sw128(a + ks * 32, 16, 1024),
                  desc_sw128(b + ks * 32, 16, 1024), !(fresh && ks == 0));
}

// One chunk's products over all panels from the ring, the A and B panels
// of each in turn (slots i, i + 1, ...); a pair goes back once the next
// pair's products are issued.  Returns the next ring index.
__device__ __forceinline__ uint32_t streamed_chunk(float (&s)[64],
                                                   const Ring& ring,
                                                   uint32_t i, int P,
                                                   int wg) {
  uint32_t a = ring.take(i) + wg * 64 * 128;
  uint32_t b = ring.take(i + 1);
  wgmma_fence();
  panel_product(s, a, b, true);
  wgmma_commit();
  i += 2;
  for (int pp = 1; pp < P; ++pp) {
    a = ring.take(i) + wg * 64 * 128;
    b = ring.take(i + 1);
    wgmma_fence();
    panel_product(s, a, b, false);
    wgmma_commit();
    wgmma_wait_one();
    ring.give(i - 2);
    ring.give(i - 1);
    i += 2;
  }
  wgmma_wait_all();
  ring.give(i - 2);
  ring.give(i - 1);
  return i;
}

// rows (f32, row r at src + r * d) into bf16 panels: panel pp of tile t at
// dst + (t * P + pp) * kPanel, rows and dims past the data zero.  A thread
// writes 8 dims of a row (16 bytes of the swizzled panel).
__global__ void pack_bf16_kernel(const float* __restrict__ src, int rows,
                                 int d, int P, size_t total,
                                 uint8_t* __restrict__ dst) {
  const bool vec =
      (d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (size_t x = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       x < total; x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int grp = static_cast<int>(x & 7);
    const int r = static_cast<int>((x >> 3) & 127);
    const size_t tp = x >> 10;
    const int pp = static_cast<int>(tp % P);
    const size_t row = (tp / P) * kTile + r;
    const int j0 = pp * 64 + grp * 8;
    const float* from = src + row * d + j0;
    float v[8];
    if (row < static_cast<size_t>(rows) && vec && j0 + 8 <= d) {
      const float4 a = *reinterpret_cast<const float4*>(from);
      const float4 b = *reinterpret_cast<const float4*>(from + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = row < static_cast<size_t>(rows) && j0 + e < d ? from[e] : 0.0f;
    }
    *reinterpret_cast<uint4*>(dst + tp * kPanel + tile_byte(r, grp * 8)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// |c|^2 of the un-rounded centroids, fmaf over ascending dims (the fused
// kernel's bits); +inf for the padding rows past k.
__global__ void norms_kernel(const float* __restrict__ cent, int k, int d,
                             int kpad, float* __restrict__ c2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= kpad) return;
  float s = __int_as_float(0x7f800000);
  if (c < k) {
    const float* row = cent + static_cast<size_t>(c) * d;
    s = 0.0f;
    for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
  }
  c2[c] = s;
}

// This lane's norms of a chunk (c2c its 128): cc[j] for columns 8 j +
// 2 q and + 1.
__device__ __forceinline__ void lane_norms(const float* c2c, int q,
                                           float2 (&cc)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    cc[j] = *reinterpret_cast<const float2*>(c2c + 8 * j + 2 * q);
}

// Row h's 32 scores -2 * dot + |c|^2 of this lane (one fmaf each, as the
// fused kernel) from the chunk's products s: v[2 j + b] for column
// 8 j + 2 q + b (s[4 j + e]: row 16 w + g + 8 (e / 2), column
// 8 j + 2 q + e % 2).  s is not written.
__device__ __forceinline__ void row_scores(const float (&s)[64],
                                           const float2 (&cc)[16], int h,
                                           float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    v[2 * j] = fmaf(-2.0f, s[4 * j + 2 * h], cc[j].x);
    v[2 * j + 1] = fmaf(-2.0f, s[4 * j + 2 * h + 1], cc[j].y);
  }
}

// This lane's bits (2 j + b) of the scores v equal to m, which none lies
// below: a score is never -0, so s == m exactly where m - s is +0, and
// the sign bits of m - s are the bits of s > m, shifted in one at a time
// in four independent bytes.
__device__ __forceinline__ uint32_t row_ties(const float (&v)[32], float m) {
  uint32_t above[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int u = 31; u >= 0; --u)
    above[u >> 3] =
        __funnelshift_l(__float_as_uint(m - v[u]), above[u >> 3], 1);
  return ~(above[0] | (above[1] << 8) | (above[2] << 16) | (above[3] << 24));
}

// Chunk `chunk`'s products s (done) into this lane's running (best,
// first, cnt) of its rows h, over its own columns: its least score so
// far, the lowest index at it and how many of its scores equal it.  The
// bits of the scores equal to min(chunk's least, best) are empty where
// the chunk's least lies above best, so the count adds nothing there; an
// equal least keeps the earlier, lower index.  The quad merges its lanes
// once a tile (quad_merge), not a chunk.
__device__ __forceinline__ void take_chunk(const float (&s)[64],
                                           const float* c2c, int chunk, int q,
                                           float (&best)[2], int (&first)[2],
                                           int (&cnt)[2]) {
  const float inf = __int_as_float(0x7f800000);
  float2 cc[16];
  lane_norms(c2c, q, cc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[32];
    row_scores(s, cc, h, v);
    float c4[4] = {inf, inf, inf, inf};
#pragma unroll
    for (int u = 0; u < 32; ++u) c4[u & 3] = fminf(c4[u & 3], v[u]);
    const float m = fminf(fminf(c4[0], c4[1]), fminf(c4[2], c4[3]));
    const uint32_t eq = row_ties(v, fminf(m, best[h]));
    if (m < best[h]) {
      const int bit = __ffs(eq) - 1;
      best[h] = m;
      first[h] = chunk * 128 + 8 * (bit >> 1) + 2 * q + (bit & 1);
      cnt[h] = __popc(eq);
    } else {
      cnt[h] += __popc(eq);
    }
  }
}

// The quad's (least score, lowest index at it, count at it) of a row from
// its lanes' own.
__device__ __forceinline__ void quad_merge(float& best, int& first,
                                           int& cnt) {
  float m = fminf(best, __shfl_xor_sync(0xffffffffu, best, 1));
  m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  int f = best == m ? first : 0x7fffffff;
  int c = best == m ? cnt : 0;
  f = min(f, __shfl_xor_sync(0xffffffffu, f, 1));
  f = min(f, __shfl_xor_sync(0xffffffffu, f, 2));
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  best = m;
  first = f;
  cnt = c;
}

// Held plan: chunk cl's products against the tile's held A panels (the
// whole K in one group).
__device__ __forceinline__ void held_chunk(float (&s)[64],
                                           const uint32_t (&a)[kHeldMaxPanels],
                                           uint32_t b, int P) {
  wgmma_fence();
  panel_product(s, a[0], b, true);
#pragma unroll
  for (int pp = 1; pp < kHeldMaxPanels; ++pp)
    if (pp < P) panel_product(s, a[pp], b + pp * kPanel, false);
  wgmma_commit();
}

// The converting launch's converter warps (d 64 or 128): tile t's f32
// rows (flat floats [x0, x0 + count) of the tile, 8 dims a step) into its
// bf16 panels in shared memory (the ring slots dst[pp]), from shared
// memory (a bulk-copied piece) or, for the ragged last tile, from the
// points with rows past `rows` zero.
__device__ __forceinline__ void convert_rows(const float* src, int x0,
                                             int count, int rows, int d,
                                             uint8_t* const (&dst)[2],
                                             int t) {
  const int shift = d == 64 ? 6 : 7;
  for (int x = 8 * t; x < count; x += 8 * kConverters) {
    const int flat = x0 + x;
    const int r = flat >> shift;
    const int j = flat & (d - 1);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (r < rows) {
      a = *reinterpret_cast<const float4*>(src + x);
      b = *reinterpret_cast<const float4*>(src + x + 4);
    }
    *reinterpret_cast<uint4*>(dst[j >> 6] + tile_byte(r, j & 63)) =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                   pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
}

// smem -> device memory by the bulk-copy engine, in this thread's bulk
// group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// The converter warps' named barrier.
__device__ __forceinline__ void converters_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kConverters) : "memory");
}

// Scoring pass, one launch per run of chunks [chunk0, chunk0 + nc): each
// row's least score over them, the lowest index attaining it and how many
// do, merged into the row state of the launches before (lower indices:
// an equal minimum keeps their index and adds the counts).  The last
// launch flags, per consumer warp and tile, whether a row it holds ties,
// and writes -1 as the index of the rows past n.  Held plan: the chunks
// sit in shared memory and the producer brings a tile's P panels once;
// streamed plan: it brings the (A, B) panel pair of every chunk and panel
// in turn.  A converting launch (`convert`: the first, at d 64 or 128
// with 16-byte aligned points) packs the points itself: the producer
// bulk-copies each whole tile's f32 rows in 16 KB pieces and the three
// converter warps write its panels into the ring slots and into pts_pk,
// so the pack's bytes overlap the scoring.
__global__ void __launch_bounds__(kThreads, 1)
kmeans_bf16_score_kernel(const float* __restrict__ points,
                         uint8_t* __restrict__ pts_pk,
                         const uint8_t* __restrict__ cent_pk,
                         const float* __restrict__ c2, Rows rows,
                         uint8_t* __restrict__ flags, int n, int d,
                         WidePlan plan, int chunk0, int nc, int last,
                         int convert) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int P = plan.panels;
  uint8_t* held = smem;
  float* c2s = reinterpret_cast<float*>(smem + plan.off_c2);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  const Ring ring{smem + (plan.held ? plan.cpl * P * kPanel : 0), bars,
                  bars + plan.slots, plan.slots, nullptr};
  uint64_t* hbar = bars + 2 * plan.slots;
  uint64_t* ffull = hbar + 1;           // the f32 pieces (converting)
  uint64_t* fempty = ffull + kF32Pieces;
  float* f32 = reinterpret_cast<float*>(smem + plan.off_f32);
  const int tid = threadIdx.x;
  const int ntiles = (n + kTile - 1) / kTile;
  if (tid == 0) {
    init_ring(ring, convert ? kConverters / 32 : 1);
    mbar_init(hbar, 1);
    for (int x = 0; x < plan.pieces; ++x) {
      mbar_init(ffull + x, 1);
      mbar_init(fempty + x, kConverters / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < nc * 128; c += kThreads)
    c2s[c] = c2[static_cast<size_t>(chunk0) * 128 + c];
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - kConsumers;
    if (convert && pt >= 32) {
      // converter warps: each tile's panels into ring slots i .. i + P - 1,
      // then thread 0 of them stores the panels to pts_pk (for the later
      // launches and the sums pass), one bulk copy each
      const int ct = pt - 32;
      uint32_t i = 0, f = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, i += P) {
        uint8_t* dst[2] = {nullptr, nullptr};
        for (int pp = 0; pp < P; ++pp) {
          const uint32_t x = i + pp;
          mbar_wait(ring.empty + x % plan.slots,
                    ((x / plan.slots) & 1) ^ 1);
          dst[pp] = ring.base + static_cast<size_t>(x % plan.slots) * kPanel;
        }
        // the stores that read these slots before are done
        if (ct == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        converters_sync();
        const int tr = min(kTile, n - t * kTile);
        const float* src = points + static_cast<size_t>(t) * kTile * d;
        if (tr < kTile) {
          convert_rows(src, 0, kTile * d, tr, d, dst, ct);
        } else {
          for (int x0 = 0; x0 < kTile * d; x0 += kPanel / 4, ++f) {
            const int s = f % plan.pieces;
            mbar_wait(ffull + s, (f / plan.pieces) & 1);
            convert_rows(f32 + s * (kPanel / 4), x0, kPanel / 4, kTile, d,
                         dst, ct);
            warp_arrive(fempty + s);
          }
        }
        fence_proxy_async();
        converters_sync();
        if (ct == 0) {
          for (int pp = 0; pp < P; ++pp)
            bulk_store(pts_pk + (static_cast<size_t>(t) * P + pp) * kPanel,
                       dst[pp], kPanel);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
        for (int pp = 0; pp < P; ++pp)
          warp_arrive(ring.full + (i + pp) % plan.slots);
      }
      if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      return;
    }
    if (pt != 0) return;
    if (plan.held) {
      mbar_expect_tx(hbar, static_cast<uint32_t>(nc * P * kPanel));
      for (int x = 0; x < nc * P; ++x)
        bulk_copy(held + static_cast<size_t>(x) * kPanel,
                  cent_pk + (static_cast<size_t>(chunk0) * P + x) * kPanel,
                  kPanel, hbar);
    }
    if (convert) {
      // each whole tile's f32 rows in 16 KB pieces (the ragged last tile
      // the converters read themselves)
      uint32_t f = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        if (n - t * kTile < kTile) break;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(
            points + static_cast<size_t>(t) * kTile * d);
        for (int off = 0; off < kTile * d * 4; off += kPanel, ++f) {
          const int s = f % plan.pieces;
          mbar_wait(fempty + s, ((f / plan.pieces) & 1) ^ 1);
          mbar_expect_tx(ffull + s, kPanel);
          bulk_copy(f32 + s * (kPanel / 4), src + off, kPanel, ffull + s);
        }
      }
      return;
    }
    uint32_t i = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const uint8_t* a = pts_pk + static_cast<size_t>(t) * P * kPanel;
      if (plan.held) {
        for (int pp = 0; pp < P; ++pp) ring.push(i++, a + pp * kPanel);
      } else {
        for (int cl = 0; cl < nc; ++cl)
          for (int pp = 0; pp < P; ++pp) {
            ring.push(i++, a + pp * kPanel);
            ring.push(i++, cent_pk + ((static_cast<size_t>(chunk0) + cl) * P +
                                      pp) * kPanel);
          }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7;
  const int wi = (tid & 127) >> 5;
  const int g = (tid & 31) >> 2;
  const int q = tid & 3;
  if (plan.held) mbar_wait(hbar, 0);
  uint32_t i = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    size_t row[2];
    float cm[2] = {0.0f, 0.0f};
    int ci[2] = {0, 0}, cc[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = static_cast<size_t>(t) * kTile + wg * 64 + 16 * wi + g + 8 * h;
      if (chunk0 > 0 && row[h] < static_cast<size_t>(n)) {
        cm[h] = rows.m[row[h]];
        ci[h] = rows.idx[row[h]];
        cc[h] = rows.cnt[row[h]];
      }
    }
    float best[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
    int first[2] = {0x7fffffff, 0x7fffffff}, cnt[2] = {0, 0};
    if (plan.held) {
      uint32_t a[kHeldMaxPanels];
#pragma unroll
      for (int pp = 0; pp < kHeldMaxPanels; ++pp)
        if (pp < P) a[pp] = ring.take(i + pp) + wg * 64 * 128;
      for (int cl = 0; cl < nc; ++cl) {
        float s[64];
        held_chunk(s, a, smem_u32(held + static_cast<size_t>(cl) * P *
                                             kPanel), P);
        wgmma_wait_all();
        fence_regs(s);
        take_chunk(s, c2s + cl * 128, chunk0 + cl, q, best, first, cnt);
      }
      for (int pp = 0; pp < P; ++pp) ring.give(i + pp);
      i += P;
    } else {
      for (int cl = 0; cl < nc; ++cl) {
        float s[64];
        i = streamed_chunk(s, ring, i, P, wg);
        fence_regs(s);
        take_chunk(s, c2s + cl * 128, chunk0 + cl, q, best, first, cnt);
      }
    }
    bool tied = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = row[h] < static_cast<size_t>(n);
      quad_merge(best[h], first[h], cnt[h]);
      if (chunk0 > 0) {
        if (best[h] == cm[h]) {
          first[h] = ci[h];
          cnt[h] += cc[h];
        } else if (!(best[h] < cm[h])) {
          best[h] = cm[h];
          first[h] = ci[h];
          cnt[h] = cc[h];
        }
      }
      if (q == 0) {
        if (valid) {
          rows.m[row[h]] = best[h];
          rows.idx[row[h]] = first[h];
          rows.cnt[row[h]] = cnt[h];
        } else if (last) {
          rows.idx[row[h]] = -1;
        }
      }
      tied |= valid && cnt[h] > 1;
    }
    const bool any = __any_sync(0xffffffffu, tied);
    if (last && (tid & 31) == 0)
      flags[static_cast<size_t>(t) * kConsumerWarps + (tid >> 5)] = any;
  }
}

// S^T's A fragments of one 64-cluster block (clusters c0 = the block's
// 16 w + g, and c0 + 8) for a tile whose rows each count once, at the
// cluster of idx (the tile's row indices in shared memory; -1 counts
// nowhere): the pair of points (16 ks + 2 q, + 1) and (+ 8, + 9) as bf16
// ones where their index is c0 (c0 + 8); the counts tallied from the same
// compares.
__device__ __forceinline__ void index_fragments(const int* idx, int c0,
                                                int q, uint32_t (&a)[8][4],
                                                float (&cnt)[2]) {
  int tally[2] = {0, 0};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int2 lo = *reinterpret_cast<const int2*>(idx + 16 * ks + 2 * q);
    const int2 hi = *reinterpret_cast<const int2*>(idx + 16 * ks + 2 * q + 8);
    const int pts[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 8 * h;
      uint32_t r[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool x = pts[2 * e] == c;
        const bool y = pts[2 * e + 1] == c;
        r[e] = (x ? 0x3f80u : 0u) | (y ? 0x3f800000u : 0u);
        tally[h] += static_cast<int>(x) + static_cast<int>(y);
      }
      a[ks][h] = r[0];
      a[ks][h + 2] = r[1];
    }
  }
  cnt[0] += static_cast<float>(tally[0]);
  cnt[1] += static_cast<float>(tally[1]);
}

// sums_blocks for a tile whose rows each count once: the fragments from
// the row indices, cbase the slab's first cluster.
__device__ __forceinline__ void index_sums(uint32_t t_base, const int* idx,
                                           int cbase, float (&part)[2][32],
                                           float (&cnt)[2][2], bool fresh,
                                           int nmb, int wg, int wi, int g,
                                           int q) {
  fence_regs(part[0]);
  fence_regs(part[1]);
  uint32_t a0[8][4];
  index_fragments(idx, cbase + wg * 64 + 16 * wi + g, q, a0, cnt[0]);
  sums_product(t_base, a0, part[0], fresh);
  if (wg + 2 < nmb) {
    uint32_t a1[8][4];
    index_fragments(idx, cbase + (wg + 2) * 64 + 16 * wi + g, q, a1, cnt[1]);
    sums_product(t_base, a1, part[1], fresh);
  }
  wgmma_wait_all();
  fence_regs(part[0]);
  fence_regs(part[1]);
}

// Sums pass: job j (of slab j / P, panel j % P) over tiles rank, rank +
// reps, ... for work item w = rank * jobs + j.  A tile's panel comes with
// its rows' indices.  Where each row counts once (every tile under first,
// an unflagged one under fast or split) the one-hot fragments come from
// the indices; on a flagged tile the group rescores its rows against the
// slab's chunks (the same wgmma sequence, the same bits) and masks the
// scores equal to each row's minimum (shares 1 or 1/count), the fused
// kernel's sums from the masks of both groups.  The partial stays in
// registers, written once per work item.
template <int POLICY>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_bf16_sums_kernel(const uint8_t* __restrict__ pts_pk,
                        const uint8_t* __restrict__ cent_pk,
                        const float* __restrict__ c2, Rows rows,
                        const uint8_t* __restrict__ flags,
                        float* __restrict__ partial,
                        float* __restrict__ pcounts, int n, int k,
                        WidePlan plan, int reps) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int P = plan.panels;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + plan.off_sbar);
  const Ring ring{smem, bars, bars + kRingSlots, kRingSlots,
                  smem + plan.off_aux};
  uint32_t* masks2 = reinterpret_cast<uint32_t*>(smem + plan.off_mask);
  float* wf2 = reinterpret_cast<float*>(smem + plan.off_wf);
  uint16_t* wb2 = reinterpret_cast<uint16_t*>(smem + plan.off_wb);
  const int tid = threadIdx.x;
  const int ntiles = (n + kTile - 1) / kTile;
  const int work = plan.jobs * reps;
  if (tid == 0) {
    init_ring(ring);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != kConsumers) return;
    uint32_t i = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const int job = w % plan.jobs;
      const int slab = job / P;
      const int pp = job % P;
      const int nsc = min(2, plan.kchunks - 2 * slab);
      for (int t = w / plan.jobs; t < ntiles; t += reps) {
        const uint8_t* a = pts_pk + static_cast<size_t>(t) * P * kPanel;
        if (POLICY != kFirst &&
            *reinterpret_cast<const uint64_t*>(flags + static_cast<size_t>(t) *
                                                           kConsumerWarps))
          for (int cl = 0; cl < nsc; ++cl)
            for (int p2 = 0; p2 < P; ++p2) {
              ring.push(i++, a + p2 * kPanel);
              ring.push(i++, cent_pk + ((static_cast<size_t>(2 * slab) + cl) *
                                            P + p2) * kPanel);
            }
        ring.push(i++, a + pp * kPanel,
                  rows.idx + static_cast<size_t>(t) * kTile);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int wi = wt >> 5;
  const int g = (tid & 31) >> 2;
  const int q = tid & 3;
  uint32_t i = 0;
  int it = 0;
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const int job = w % plan.jobs;
    const int slab = job / P;
    const int nsc = min(2, plan.kchunks - 2 * slab);
    const int nmb = min(4, (k - slab * kSlab + 63) / 64);
    float part[2][32];
    float cnt[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    bool fresh = true;
    for (int t = w / plan.jobs; t < ntiles; t += reps) {
      const size_t row0 = static_cast<size_t>(t) * kTile;
      const bool flagged =
          POLICY != kFirst &&
          *reinterpret_cast<const uint64_t*>(flags + static_cast<size_t>(t) *
                                                         kConsumerWarps) != 0;
      if (!flagged) {
        const uint32_t t_base = ring.take(i);
        const int* idx =
            reinterpret_cast<const int*>(ring.aux + (i % kRingSlots) * kAux);
        if (nmb > wg)
          index_sums(t_base, idx, slab * kSlab, part, cnt, fresh, nmb, wg,
                     wi, g, q);
        ring.give(i);
        ++i;
        fresh = false;
        continue;
      }
      // a flagged tile: this group rescores its 64 rows against the
      // slab's chunks; the masks of both groups' rows, then the sums
      uint32_t* masks = masks2 + (it & 1) * kMaskWords * kTile;
      float* wf = wf2 + (it & 1) * kTile;
      uint16_t* wb = wb2 + (it & 1) * kTile;
      ++it;
      float mstar[2];
      int tc[2];
      bool valid[2];
      int prow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        prow[h] = wg * 64 + 16 * wi + g + 8 * h;
        valid[h] = row0 + prow[h] < static_cast<size_t>(n);
        mstar[h] = valid[h] ? rows.m[row0 + prow[h]] : 0.0f;
        tc[h] = valid[h] ? rows.cnt[row0 + prow[h]] : 1;
      }
      for (int cl = 0; cl < 2; ++cl) {
        uint32_t eq[2] = {0u, 0u};
        if (cl < nsc) {
          float s[64];
          i = streamed_chunk(s, ring, i, P, wg);
          fence_regs(s);
          float2 cc[16];
          lane_norms(c2 + (static_cast<size_t>(2 * slab) + cl) * 128, q, cc);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v[32];
            row_scores(s, cc, h, v);
            eq[h] = row_ties(v, mstar[h]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          masks[(4 * cl + q) * kTile + prow[h]] = valid[h] ? eq[h] : 0u;
      }
      if (q == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float share =
              POLICY == kSplit ? 1.0f / static_cast<float>(tc[h]) : 1.0f;
          wf[prow[h]] = valid[h] ? share : 0.0f;
          wb[prow[h]] =
              valid[h] ? __bfloat16_as_ushort(__float2bfloat16_rn(share)) : 0;
        }
      }
      consumers_sync();
      const uint32_t t_base = ring.take(i);
      if (nmb > wg) {
        if (POLICY == kSplit)
          sums_blocks<false>(t_base, masks, wf, wb, part, cnt, fresh, nmb, wg,
                             wi, g, q);
        else
          sums_blocks<true>(t_base, masks, wf, wb, part, cnt, fresh, nmb, wg,
                            wi, g, q);
      }
      ring.give(i);
      ++i;
      fresh = false;
    }
    // the work item's partial, written once
    float* my_part = partial + static_cast<size_t>(w) * kSlab * 64;
    float* my_cnt = pcounts + static_cast<size_t>(w) * kSlab;
#pragma unroll
    for (int mbi = 0; mbi < 2; ++mbi) {
      const int mb = 2 * mbi + wg;
      if (mb >= nmb) break;
      const int c0 = mb * 64 + 16 * wi + g;
#pragma unroll
      for (int r = 0; r < 32; ++r)
        my_part[(c0 + 8 * ((r >> 1) & 1)) * 64 + 8 * (r >> 2) + 2 * q +
                (r & 1)] = part[mbi][r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = cnt[mbi][h];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (q == 0) my_cnt[c0 + 8 * h] = x;
      }
    }
  }
}

// sums and counts = the work items' partials of each job added in rank
// order (counts from each slab's first panel).
__global__ void reduce_wide_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ pcounts,
                                   int jobs, int reps, int P, int k, int d,
                                   float* __restrict__ sums,
                                   float* __restrict__ counts) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t kd = static_cast<size_t>(k) * d;
  if (i < kd) {
    const int c = static_cast<int>(i / d);
    const int j = static_cast<int>(i - static_cast<size_t>(c) * d);
    const int job = (c / kSlab) * P + j / 64;
    const float* src = partial + (static_cast<size_t>(job) * kSlab +
                                  c % kSlab) * 64 + j % 64;
    const size_t step = static_cast<size_t>(jobs) * kSlab * 64;
    float s = 0.0f;
    for (int r = 0; r < reps; ++r) s += src[r * step];
    sums[i] = s;
  } else if (i < kd + k) {
    const int c = static_cast<int>(i - kd);
    const float* src =
        pcounts + static_cast<size_t>((c / kSlab) * P) * kSlab + c % kSlab;
    const size_t step = static_cast<size_t>(jobs) * kSlab;
    float s = 0.0f;
    for (int r = 0; r < reps; ++r) s += src[r * step];
    counts[c] = s;
  }
}

typedef void (*SumsFn)(const uint8_t*, const uint8_t*, const float*, Rows,
                       const uint8_t*, float*, float*, int, int, WidePlan,
                       int);

SumsFn sums_for(int policy) {
  switch (policy) {
    case kFirst: return kmeans_bf16_sums_kernel<kFirst>;
    case kFast: return kmeans_bf16_sums_kernel<kFast>;
    case kSplit: return kmeans_bf16_sums_kernel<kSplit>;
    default: return nullptr;
  }
}

// Blocks that fit on the card at once for fn at smem bytes.
cudaError_t blocks_fit(const void* fn, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return cudaSuccess;
}

// The two-pass launch's grids and scratch: score grid, sums reps (work
// items a job: jobs x reps items) and grid, and the byte offsets of the
// packed points, packed centroids, norms, the row state (m, idx, cnt),
// flags, counts and partials, and the total.
struct WideLaunch {
  int score_grid, reps, sums_grid;
  size_t off_pts, off_cent, off_c2, off_m, off_idx, off_cnt_rows, off_flags,
      off_cnt, off_part, bytes;
};

cudaError_t make_wide_launch(SumsFn fn, const WidePlan& plan, int n,
                             WideLaunch* l) {
  int fit = 0;
  cudaError_t err = blocks_fit(
      reinterpret_cast<const void*>(kmeans_bf16_score_kernel),
      plan.smem_score, &fit);
  if (err != cudaSuccess) return err;
  const int ntiles = (n + kTile - 1) / kTile;
  l->score_grid = std::min(ntiles, fit);
  if ((err = blocks_fit(reinterpret_cast<const void*>(fn), plan.smem_sums,
                        &fit)) != cudaSuccess)
    return err;
  l->reps = std::max(1, std::min(ntiles, fit / plan.jobs));
  const int work = plan.jobs * l->reps;
  l->sums_grid = std::min(work, fit);
  auto up = [](size_t x) { return (x + 1023) / 1024 * 1024; };
  const size_t P = plan.panels;
  size_t off = 0;
  l->off_pts = off;
  off = up(off + static_cast<size_t>(ntiles) * P * kPanel);
  l->off_cent = off;
  off = up(off + static_cast<size_t>(plan.kchunks) * P * kPanel);
  l->off_c2 = off;
  off = up(off + static_cast<size_t>(plan.kchunks) * 128 * 4);
  const size_t nrows = static_cast<size_t>(ntiles) * kTile;
  l->off_m = off;
  off = up(off + nrows * 4);
  l->off_idx = off;
  off = up(off + nrows * 4);
  l->off_cnt_rows = off;
  off = up(off + nrows * 4);
  l->off_flags = off;
  off = up(off + static_cast<size_t>(ntiles) * kConsumerWarps);
  l->off_cnt = off;
  off = up(off + static_cast<size_t>(work) * kSlab * 4);
  l->off_part = off;
  off = up(off + static_cast<size_t>(work) * kSlab * 64 * 4);
  l->bytes = off;
  return cudaSuccess;
}

int wide_launch(int policy, const float* points, const float* cent,
                uint8_t* scratch, float* sums, float* counts, int n, int k,
                int d, int cpl, cudaStream_t s) {
  WidePlan plan;
  SumsFn fn = sums_for(policy);
  if (fn == nullptr || !make_wide_plan(k, d, cpl, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t kd = static_cast<size_t>(k) * d;
  if (n == 0) {
    cudaMemsetAsync(sums, 0, kd * 4, s);
    cudaMemsetAsync(counts, 0, static_cast<size_t>(k) * 4, s);
    return static_cast<int>(cudaGetLastError());
  }
  WideLaunch l;
  cudaError_t err = make_wide_launch(fn, plan, n, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* pts_pk = scratch + l.off_pts;
  uint8_t* cent_pk = scratch + l.off_cent;
  float* c2 = reinterpret_cast<float*>(scratch + l.off_c2);
  const Rows rows{reinterpret_cast<float*>(scratch + l.off_m),
                  reinterpret_cast<int*>(scratch + l.off_idx),
                  reinterpret_cast<int*>(scratch + l.off_cnt_rows)};
  uint8_t* flags = scratch + l.off_flags;
  float* pcounts = reinterpret_cast<float*>(scratch + l.off_cnt);
  float* partial = reinterpret_cast<float*>(scratch + l.off_part);
  const int ntiles = (n + kTile - 1) / kTile;
  // the first scoring launch packs the points where it can (d 64 or 128,
  // 16-byte aligned rows), else this kernel does
  const int convert =
      plan.converts && (reinterpret_cast<uintptr_t>(points) & 15) == 0;
  const size_t pts_threads =
      static_cast<size_t>(ntiles) * plan.panels * kTile * 8;
  if (!convert)
    pack_bf16_kernel<<<static_cast<unsigned>(
                           std::min<size_t>((pts_threads + 255) / 256, 8192)),
                       256, 0, s>>>(points, n, d, plan.panels, pts_threads,
                                    pts_pk);
  const size_t cent_threads =
      static_cast<size_t>(plan.kchunks) * plan.panels * kTile * 8;
  pack_bf16_kernel<<<static_cast<unsigned>(
                         std::min<size_t>((cent_threads + 255) / 256, 8192)),
                     256, 0, s>>>(cent, k, d, plan.panels, cent_threads,
                                  cent_pk);
  norms_kernel<<<plan.kchunks * 128 / 256 + 1, 256, 0, s>>>(
      cent, k, d, plan.kchunks * 128, c2);
  for (int L = 0; L < plan.launches; ++L) {
    const int chunk0 = L * plan.cpl;
    const int nc = std::min(plan.cpl, plan.kchunks - chunk0);
    kmeans_bf16_score_kernel<<<l.score_grid, kThreads, plan.smem_score, s>>>(
        points, pts_pk, cent_pk, c2, rows, flags, n, d, plan, chunk0, nc,
        L == plan.launches - 1, convert && L == 0);
  }
  fn<<<l.sums_grid, kThreads, plan.smem_sums, s>>>(
      pts_pk, cent_pk, c2, rows, flags, partial, pcounts, n, k, plan,
      l.reps);
  reduce_wide_kernel<<<static_cast<unsigned>((kd + k + 255) / 256), 256, 0,
                       s>>>(partial, pcounts, plan.jobs, l.reps, plan.panels,
                            k, d, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

typedef void (*KernelFn)(const float*, const float*, float*, float*, int, int,
                         int, Plan, int);

KernelFn kernel_for(int policy) {
  switch (policy) {
    case kFirst: return kmeans_bf16_kernel<kFirst>;
    case kFast: return kmeans_bf16_kernel<kFast>;
    case kSplit: return kmeans_bf16_kernel<kSplit>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The caller's plan (ops/kmeans.py::bf16_plan) comes as `route` (0 the
// fused pass, 1 two passes) and `chunks` (score products of 128 centroids
// a tile; chunks a scoring launch); a plan that does not hold the shape
// or fit shared memory is cudaErrorInvalidValue.
//
// Blocks of the main (fused, or scoring) kernel for this plan, and the
// floats of scratch the launch needs.
int kmeans_bf16_grid(int policy, int n, int k, int d, int route, int chunks,
                     int* grid, int64_t* scratch) {
  Plan plan;
  KernelFn fn = kernel_for(policy);
  if (fn == nullptr || n < 0 || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    WidePlan wide;
    if (!make_wide_plan(k, d, chunks, &wide))
      return static_cast<int>(cudaErrorInvalidValue);
    *grid = 0;
    *scratch = 0;
    if (n == 0) return static_cast<int>(cudaGetLastError());
    WideLaunch l;
    const cudaError_t err = make_wide_launch(sums_for(policy), wide, n, &l);
    if (err != cudaSuccess) return static_cast<int>(err);
    *grid = l.score_grid;
    *scratch = static_cast<int64_t>((l.bytes + 3) / 4);
    return static_cast<int>(cudaGetLastError());
  }
  if (!make_plan(k, d, chunks, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  int fit = 0;
  const cudaError_t err =
      blocks_fit(reinterpret_cast<const void*>(fn), plan.smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (n + kTile - 1) / kTile;
  *grid = ntiles < fit ? ntiles : fit;
  *scratch = static_cast<int64_t>(*grid) * k * (d + 1);
  return static_cast<int>(cudaGetLastError());
}

// Fused: scratch = block counts (grid * k) | block sums (grid * k * d).
// Two-pass: the layout of make_wide_launch (grid unused).
int kmeans_bf16_launch(int policy, const void* points, const void* cent,
                       void* scratch, void* sums, void* counts, int n, int k,
                       int d, int route, int chunks, int grid, void* stream) {
  Plan plan;
  KernelFn fn = kernel_for(policy);
  if (fn == nullptr || n < 0 || grid < 0 || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return wide_launch(policy, static_cast<const float*>(points),
                       static_cast<const float*>(cent),
                       static_cast<uint8_t*>(scratch),
                       static_cast<float*>(sums), static_cast<float*>(counts),
                       n, k, d, chunks, s);
  if (!make_plan(k, d, chunks, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pcounts = static_cast<float*>(scratch);
  float* partial = pcounts + static_cast<size_t>(grid) * k;
  if (grid > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int bulk = (reinterpret_cast<uintptr_t>(points) & 15) == 0;
    fn<<<grid, kThreads, plan.smem, s>>>(
        static_cast<const float*>(points), static_cast<const float*>(cent),
        partial, pcounts, n, k, d, plan, bulk);
  }
  const size_t total = static_cast<size_t>(k) * d + k;
  reduce_partials_bf16<<<static_cast<unsigned>(
                             (total + kReduceOut - 1) / kReduceOut),
                         kReduceOut * kReduceParts, 0, s>>>(
      partial, pcounts, grid, k, d, static_cast<float*>(sums),
      static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
