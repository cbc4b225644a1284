// Hand-written Hopper (sm_90a) kernel for KMeans' bf16 stats round
// (flink_ml_tpu_torch/ops/kmeans.py: kmeans_update_stats(...,
// compute_dtype=torch.bfloat16) on the shapes of bf16_plan: k <= 256,
// d <= 64).  Other shapes keep kmeans.cu's kFirstBf/kFastBf/kSplitBf.
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
// Each launcher returns cudaGetLastError() so the caller sees a refused
// launch.  A thread that waits on a barrier for ~20 s traps (a launch
// failure the wrapper raises) rather than hang.

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

bool make_plan(int k, int d, Plan* p) {
  if (k < 1 || d < 1 || k > kMaxK || d > kMaxD) return false;
  p->kp = k <= 128 ? 128 : 256;
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

// Blocks of the main kernel for this shape, and the floats of scratch the
// launch needs; cudaErrorInvalidValue for a shape outside the plan.
int kmeans_bf16_grid(int policy, int n, int k, int d, int* grid,
                     int64_t* scratch) {
  Plan plan;
  KernelFn fn = kernel_for(policy);
  if (fn == nullptr || n < 0 || !make_plan(k, d, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, plan.smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ntiles = (n + kTile - 1) / kTile;
  *grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  *scratch = static_cast<int64_t>(*grid) * k * (d + 1);
  return static_cast<int>(cudaGetLastError());
}

// scratch: block counts (grid * k) | block sums (grid * k * d)
int kmeans_bf16_launch(int policy, const void* points, const void* cent,
                       void* scratch, void* sums, void* counts, int n, int k,
                       int d, int grid, void* stream) {
  Plan plan;
  KernelFn fn = kernel_for(policy);
  if (fn == nullptr || n < 0 || grid < 0 || !make_plan(k, d, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
