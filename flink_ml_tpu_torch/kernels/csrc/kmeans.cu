// Hand-written Hopper (sm_90a) kernels for KMeans (flink_ml_tpu_torch/ops/
// kmeans.py): one Lloyd's round fused over tiles of points, the product of
// points and centroids, the assignment and the keyed (sums, counts) reduce
// in one pass over the points.
//
// One kernel template, five modes, each replacing a Pallas kernel of
// flink_ml_tpu/ops/kmeans_pallas.py:
//
// - kFirst / kFast / kSplit: kmeans_update_stats (_stats_kernel).  Scores
//   -2*dot(p, c) + |c|^2; a point goes to the first minimal index (first),
//   to every index equal to the row minimum (fast), or 1/#ties to each
//   (split).  Out: sums (k, d), counts (k,).
// - kAssign: kmeans_assign_reduce (_assign_kernel).  The first-index
//   argmin of the same scores, plus sums and counts of every row.
// - kWorkset: kmeans_workset_update (_workset_kernel).  Root distances
//   sqrt(max(|p|^2 - 2*dot + |c|^2, 0)) (the expression of the euclidean
//   pairwise form), first-index argmin, best and second-best distance,
//   merged with the cached assignment where the point is not active;
//   stats of the merged assignment weighted by pad_mask.
//
// Bound on the H100 at the headline (n = 2^20, d = 64, k = 256, f32): the
// product is 2*n*k*d = 3.4e10 operations, 0.51 ms at the 67 TFLOP/s of the
// CUDA cores, and 3 x 3.4e10 of TF32 products, 0.21 ms at the 495 TFLOP/s
// of the tensor cores; the bytes (points read once, 268 MB) take 0.08 ms.
// So the kernels are bound by operations, and the design keeps the scores,
// the one-hot and the partial sums out of device memory.  (The bf16
// variant, compute_dtype=bfloat16, is kmeans_bf16.cu's.)
//
// - A block takes tiles of 128 points and walks over tiles b, b + G,
//   b + 2G, ... (G = blocks that fit on the card at once).  The centroids
//   sit in shared memory for the block's life (64 KB at the headline) in
//   groups of 32; warp w scores groups w, w + 8, ... against the whole
//   tile.  The next tile streams into a second buffer with cp.async while
//   this one is scored and reduced (one block per SM leaves no other block
//   to hide the load).  Where the centroids do not fit, each 256-centroid
//   slab is staged per tile in 64-dim pieces; where the tile does not fit,
//   lanes read their points from device memory: slower, but no shape is
//   refused.
// - first, assign, workset (the fit, transform and workset paths) score on
//   the tensor cores (score_tc): 3xTF32 mma.sync m16n8k8, each operand
//   split into a TF32 high and low part by integer operations as its
//   fragment is loaded (split copies of the centroids would not fit beside
//   the partial at the headline), hi*lo + lo*hi + hi*hi summed in f32.  The
//   centroids are laid out in fragment order, [group][8-dim step][lane][8],
//   and the tile's point rows are permuted (tile_pos), so a lane's B
//   fragments of a step are two 16-byte loads and its A fragments of two
//   m-tiles another two, all free of bank conflicts.  A lane folds its
//   products into per-point candidates (least score and first index, or
//   least root, first index at it and second root) and the lanes and warps
//   merge them in an order-free rule, so the first-index semantics hold.
//   The workset mode keeps squared distances and roots the two least of a
//   point (and, where two squares may round to one root, the squares near
//   the least): the result is that of rooting every score.
// - fast and split score on the CUDA cores (score_fma): a lane keeps 4
//   points x 32 centroids of dot products in registers, fmaf over
//   ascending dims (4 points as one 16-byte load from the transposed tile,
//   the group's 32 centroid values as 8 broadcast 16-byte loads, for 128
//   FMAs), so the exact-tie path below can recompute a score bit for bit.
// - The Pallas grid carried sums and counts from one sequential step to
//   the next.  Hopper blocks run in no order, so each block keeps a
//   private (k, d) partial and (k,) count, in shared memory where they fit
//   (else in its own slice of the scratch buffer), and a second small
//   kernel sums the partials of all blocks in block order.  Inside a block
//   the cluster row c is owned by warp c % 8, whose lanes split the dims
//   and add the warp's points in tile order.  No atomics: every sum is
//   taken in a fixed order and the results do not change from run to
//   run.
// - Exact ties (duplicated centroids, zero pad rows against duplicated
//   min-norm centroids) under fast/split: each owning warp recomputes the
//   score of each of its clusters with score_fma's arithmetic (dot_of) and
//   adds the point where it equals the minimum.
// - Every row count is taken; the last tile is masked.  Zero pad rows are
//   scored like any row (the caller's pad_correction removes them).
//
// Each launcher returns cudaGetLastError() so the caller sees a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuad = 4;        // points per lane
constexpr int kTile = 32 * kQuad;   // points per tile
constexpr int kTileStride = kTile + 4;  // transposed tile row (16-byte
                                        // aligned, 4-way bank spread)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 32;      // centroids per register group
constexpr int kSlabDims = 64;   // dims per slab when centroids are staged
constexpr int kMtGroup = 4;     // m-tiles whose products interleave (even)
constexpr size_t kSmemLimit = 232448;  // 227 KB, Hopper's per-block opt-in
constexpr int kPointArrays = 5;  // per-point arrays of a tile in shared
                                 // memory (assign, ties, best, weight, |p|^2)

enum Mode { kFirst = 0, kFast = 1, kSplit = 2, kAssign = 3, kWorkset = 4 };

struct Plan {
  int cent_res;  // all centroids resident in shared memory
  int acc_s;     // the block's partial (sums, counts) in shared memory
  int tile_s;    // point tile buffers in shared memory (2: the next tile
                 // loads while this one is scored)
  int dch;       // dims per staged slab (d when resident)
  int kpad;      // k rounded up to a whole group
  int stride;    // row stride of the partial and of the tile (d | 1: odd,
                 // so threads reading one row each hit distinct banks)
  int cent_floats;  // floats of the centroid area (dims padded to 8)
  size_t smem;
};

__host__ __device__ inline int pad8(int x) { return (x + 7) / 8 * 8; }

// Floats of the block's partial (sums, counts), rounded up to 16 bytes so
// the point tile behind it stays aligned for 16-byte loads.
__host__ __device__ inline size_t acc_floats(int k, int stride) {
  return (static_cast<size_t>(k) * stride + k + 3) / 4 * 4;
}

Plan make_plan(int k, int d) {
  Plan p;
  p.kpad = (k + kGroup - 1) / kGroup * kGroup;
  p.stride = d | 1;
  // per-point arrays and the warps' candidates
  const size_t fixed = (kPointArrays + 3 * kWarps) * kTile * sizeof(float);
  const size_t avail = kSmemLimit - fixed;
  const size_t cent = static_cast<size_t>(p.kpad) * pad8(d) * sizeof(float);
  if (cent <= avail) {
    p.cent_res = 1;
    p.dch = d;
    p.cent_floats = p.kpad * pad8(d);
  } else {
    p.cent_res = 0;
    p.dch = d < kSlabDims ? d : kSlabDims;
    p.cent_floats = kWarps * kGroup * pad8(p.dch);
  }
  size_t used = static_cast<size_t>(p.cent_floats) * sizeof(float);
  const size_t acc = acc_floats(k, p.stride) * sizeof(float);
  p.acc_s = used + acc <= avail;
  if (p.acc_s) used += acc;
  const size_t tile = static_cast<size_t>(d) * kTileStride * sizeof(float);
  p.tile_s = used + 2 * tile <= avail ? 2 : used + tile <= avail ? 1 : 0;
  used += p.tile_s * tile;
  p.smem = used + fixed;
  return p;
}

// The score of #4/#5, two roundings as in -2 * dot + c2.
__device__ __forceinline__ float score_of(float dot, float c2) {
  return __fadd_rn(__fmul_rn(-2.0f, dot), c2);
}

// The squared distance of #6, in the order (p2 - 2 * dot) + c2; its root
// is sqrtf(fmaxf(sq, 0)).
__device__ __forceinline__ float sq_of(float dot, float c2, float p2) {
  return __fadd_rn(__fsub_rn(p2, __fmul_rn(2.0f, dot)), c2);
}

// 3xTF32: x ~ hi + lo, hi the TF32 value nearest x and lo the TF32 value
// nearest x - hi (ties away from zero; integer operations, where
// cvt.rna.tf32 issues at a quarter of their rate).  hi*lo + lo*hi + hi*hi
// keeps close to the f32 product: its error is at most ~3 * 2^-22 of
// |x y| (the dropped lo*lo and the rounding of lo).
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(__fsub_rn(x, __uint_as_float(hi))));
}

// c += a * b on the tensor cores: one m16n8k8 TF32 product, f32 sums.
// a: A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b: B[t][g], B[t+4][g];
// c: C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1] (g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dot(p, c) in the order of the scoring loop (fmaf over ascending dims).
__device__ __forceinline__ float dot_of(const float* p, const float* c,
                                        int d) {
  float s = 0.0f;
  for (int j = 0; j < d; ++j) s = fmaf(p[j], c[j], s);
  return s;
}

// dst[(g * dch + j) * 32 + u] = centroid (c0 + 32 g + u), dim (j0 + j);
// zero past k.
__device__ void stage(float* dst, const float* __restrict__ cent, int k,
                      int d, int c0, int ngroups, int j0, int dch) {
  const int total = ngroups * dch * kGroup;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int u = idx & (kGroup - 1);
    const int gj = idx / kGroup;
    const int g = gj / dch;
    const int j = gj - g * dch;
    const int c = c0 + g * kGroup + u;
    const float v = c < k ? cent[static_cast<size_t>(c) * d + j0 + j] : 0.0f;
    dst[idx] = v;
  }
}

// The same centroids in the order the tensor-core B fragments read them:
// dst[((g * nst + s) * 32 + lane) * 8 + e] = centroid (c0 + 32 g + 8 (e/2)
// + lane/4), dim (j0 + 8 s + lane%4 + 4 (e%2)), for the nst = ceil(dch/8)
// 8-dim steps of the slab; zero past k and past the slab.  A lane's 8
// values of a step (its b0, b1 of 4 n-tiles) are two 16-byte loads.
__device__ void stage_frag(float* dst, const float* __restrict__ cent, int k,
                           int d, int c0, int ngroups, int j0, int dch) {
  const int nst = (dch + 7) / 8;
  const int total = ngroups * nst * 256;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int e = idx & 7;
    const int ln = (idx >> 3) & 31;
    const int gs = idx >> 8;
    const int g = gs / nst;
    const int st = gs - g * nst;
    const int c = c0 + g * kGroup + (e >> 1) * 8 + (ln >> 2);
    const int j = st * 8 + (ln & 3) + 4 * (e & 1);
    dst[idx] = c < k && j < dch ? cent[static_cast<size_t>(c) * d + j0 + j]
                                : 0.0f;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where point row r (0..127) of a tile sits in its transposed row: r
// itself, or, for the tensor-core modes, (r % 8) * 16 + r / 8, so that
// the 16 rows a lane's A fragments read for one dim (gid + 8 i) are 16
// adjacent floats: four 16-byte loads, free of bank conflicts.
template <bool kPerm>
__device__ __forceinline__ int tile_pos(int r) {
  return kPerm ? (r & 7) * 16 + (r >> 3) : r;
}

// Start copying tile `tile` into dst, transposed (dst[j * kTileStride +
// tile_pos(r)]); rows past n are zero.
template <bool kPerm>
__device__ void load_tile(float* dst, const float* __restrict__ points,
                          int tile, int n, int d) {
  const size_t row0 = static_cast<size_t>(tile) * kTile;
  const int rows = min(kTile, n - static_cast<int>(row0));
  const float* src = points + row0 * d;
  for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
    const int r = idx / d;
    float* to = dst + static_cast<size_t>(idx - r * d) * kTileStride +
                tile_pos<kPerm>(r);
    if (r < rows)
      cp_async4(to, src + idx);
    else
      *to = 0.0f;
  }
  cp_async_commit();
}

// Dim j of this lane's 4 points: from the transposed tile, or from the
// point rows where the tile does not fit in shared memory.
__device__ __forceinline__ float4 load_quad(const float* tile_s,
                                            const float* const (&prow)[kQuad],
                                            int j, int lane) {
  if (tile_s != nullptr)
    return *reinterpret_cast<const float4*>(
        tile_s + static_cast<size_t>(j) * kTileStride + kQuad * lane);
  return make_float4(__ldg(prow[0] + j), __ldg(prow[1] + j),
                     __ldg(prow[2] + j), __ldg(prow[3] + j));
}

// acc[j] += w * p[j * pstep] over the row (the point's dims lie pstep
// apart: 1 in device memory, kTileStride in the transposed tile), the
// warp's lanes on alternate dims; lane 0 adds w to the count.
// Warp-uniform call.
__device__ __forceinline__ void warp_add_row(float* acc, float* cnt,
                                             const float* p, int pstep,
                                             int d, float w, int lane) {
  for (int j = lane; j < d; j += 32) {
    const float v = p[static_cast<size_t>(j) * pstep];
    acc[j] += w * v;
  }
  if (lane == 0) *cnt += w;
}

// Running minimum over one point's scores, in ascending centroid order
// (the CUDA-core scoring of fast and split): the first minimal index and
// the count of exact ties.
__device__ __forceinline__ void take(float v, int c, float& best, int& idx,
                                     float& ties) {
  if (v < best) {
    best = v;
    idx = c;
    ties = 1.0f;
  } else if (v == best) {
    ties += 1.0f;
  }
}

// Merge the candidate of a disjoint centroid set into (best, idx, x); the
// result does not depend on the order of the merges.
template <int MODE>
__device__ __forceinline__ void merge(float& best, int& idx, float& x,
                                      float b2, int i2, float x2) {
  if (MODE == kWorkset) {
    if (b2 < best) {
      x = fminf(best, x2);
      best = b2;
      idx = i2;
    } else if (b2 == best) {
      x = best;
      idx = min(idx, i2);
    } else {
      x = fminf(x, b2);
    }
  } else {
    if (b2 < best) {
      best = b2;
      idx = i2;
      x = x2;
    } else if (b2 == best) {
      x += x2;
      idx = min(idx, i2);
    }
  }
}

// The modes that score on the tensor cores; fast and split keep the CUDA
// cores, whose scores the exact-tie path can recompute.
template <int MODE>
__device__ __forceinline__ constexpr bool kTensorCores() {
  return MODE == kFirst || MODE == kAssign || MODE == kWorkset;
}

// Scores on the CUDA cores (the fast and split modes): a lane keeps 4
// points x 32 centroids of dot products, fmaf over ascending dims, and
// each warp writes its candidates (over its groups w, w + kWarps, ...) to
// its row of cand_*.  The exact-tie path of the keyed reduce rescores
// with the same arithmetic (dot_of).
template <int MODE>
__device__ __forceinline__ void score_fma(
    const float* tile_s, const float* __restrict__ points, size_t row0,
    int n, int k, int d, const float* __restrict__ cent,
    const float* __restrict__ c2, float* cent_s, const Plan& plan,
    float* cand_b, int* cand_i, float* cand_x) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ngroups = plan.kpad / kGroup;
  const int nsuper = (ngroups + kWarps - 1) / kWarps;
  // this lane's 4 points: tile rows 4 * lane .. 4 * lane + 3
  const float* prow[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i)
    prow[i] = points + static_cast<size_t>(min(row0 + kQuad * lane + i,
                                               static_cast<size_t>(n) - 1)) * d;
  float best[kQuad];
  float x[kQuad];
  int idx[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    best[i] = __int_as_float(0x7f800000);
    x[i] = 0.0f;
    idx[i] = 0x7fffffff;
  }
  // score: warp w takes groups w, w + kWarps, ... (ascending)
  for (int sg = 0; sg < nsuper; ++sg) {
    const int g = sg * kWarps + warp;
    const bool has = g < ngroups;  // warp-uniform
    float dot[kQuad][kGroup];
#pragma unroll
    for (int i = 0; i < kQuad; ++i)
#pragma unroll
      for (int u = 0; u < kGroup; ++u) dot[i][u] = 0.0f;
    for (int j0 = 0; j0 < d; j0 += plan.dch) {
      const int len = min(plan.dch, d - j0);
      const float* slab;
      if (plan.cent_res) {
        slab = cent_s + static_cast<size_t>(g) * d * kGroup;
      } else {
        __syncthreads();
        stage(cent_s, cent, k, d, sg * kWarps * kGroup, kWarps, j0, len);
        __syncthreads();
        slab = cent_s + static_cast<size_t>(warp) * len * kGroup;
      }
      if (has) {
#pragma unroll 2
        for (int j = 0; j < len; ++j) {
          const float4 pv = load_quad(tile_s, prow, j0 + j, lane);
          const float4* s4 =
              reinterpret_cast<const float4*>(slab + j * kGroup);
#pragma unroll
          for (int q = 0; q < kGroup / 4; ++q) {
            const float4 v = s4[q];
            const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dot[0][4 * q + e] = fmaf(pv.x, cv[e], dot[0][4 * q + e]);
              dot[1][4 * q + e] = fmaf(pv.y, cv[e], dot[1][4 * q + e]);
              dot[2][4 * q + e] = fmaf(pv.z, cv[e], dot[2][4 * q + e]);
              dot[3][4 * q + e] = fmaf(pv.w, cv[e], dot[3][4 * q + e]);
            }
          }
        }
      }
    }
    if (has) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int c = g * kGroup + u;
        if (c < k) {
          const float cc = __ldg(c2 + c);
#pragma unroll
          for (int i = 0; i < kQuad; ++i) {
            take(score_of(dot[i][u], cc), c, best[i], idx[i], x[i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    const int p = kQuad * lane + i;
    cand_b[warp * kTile + p] = best[i];
    cand_i[warp * kTile + p] = idx[i];
    cand_x[warp * kTile + p] = x[i];
  }
}

// The lane's sums of a group, acc[mt][nt][e], as candidates: slot pt
// (0..15) is the point of m-tile pt / 2, row gid + 8 (pt % 2); q (0..7)
// the centroid g * 32 + 8 (q / 2) + 2 tig + q % 2, ascending in q.
#define KM_ACC(pt, q) acc[(pt) >> 1][(q) >> 1][2 * ((pt) & 1) + ((q) & 1)]
#define KM_CENT(q) (g * kGroup + ((q) >> 1) * 8 + 2 * tig + ((q) & 1))

// The row of the warp's candidates for slot 4 jj + tig, which this lane
// owns after the quad's reduce-scatter.
__device__ __forceinline__ int owned_point(int jj, int gid, int tig) {
  return (2 * jj + (tig >> 1)) * 16 + gid + 8 * (tig & 1);
}

// first, assign: the least score and its first index per point, over the
// lane's 8 centroids; a reduce-scatter over the quad (the xor-1 step keeps
// the slots of parity tig % 2, the xor-2 step the slots 4 jj + tig), and
// the lane's 4 results merged into the warp's candidates.
template <int MODE>
__device__ __forceinline__ void fold_scores(
    float (&acc)[8][4][4], const float (&cc)[8], const bool (&ok)[8], int g,
    int gid, int tig, float* my_b, int* my_i, float* my_x) {
  float bst[16];
  int ix[16];
#pragma unroll
  for (int pt = 0; pt < 16; ++pt) {
    bst[pt] = __int_as_float(0x7f800000);
    ix[pt] = 0x7fffffff;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = score_of(KM_ACC(pt, q), cc[q]);
      if (ok[q] && v < bst[pt]) {
        bst[pt] = v;
        ix[pt] = KM_CENT(q);
      }
    }
  }
  float b8[8];
  int i8[8];
  const bool odd1 = tig & 1;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float kb = odd1 ? bst[2 * jj + 1] : bst[2 * jj], kx = 0.0f;
    int ki = odd1 ? ix[2 * jj + 1] : ix[2 * jj];
    const float rb =
        __shfl_xor_sync(kFull, odd1 ? bst[2 * jj] : bst[2 * jj + 1], 1);
    const int ri =
        __shfl_xor_sync(kFull, odd1 ? ix[2 * jj] : ix[2 * jj + 1], 1);
    merge<MODE>(kb, ki, kx, rb, ri, 0.0f);
    b8[jj] = kb;
    i8[jj] = ki;
  }
  const bool odd2 = tig & 2;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    float kb = odd2 ? b8[2 * jj + 1] : b8[2 * jj], kx = 0.0f;
    int ki = odd2 ? i8[2 * jj + 1] : i8[2 * jj];
    const float rb =
        __shfl_xor_sync(kFull, odd2 ? b8[2 * jj] : b8[2 * jj + 1], 2);
    const int ri =
        __shfl_xor_sync(kFull, odd2 ? i8[2 * jj] : i8[2 * jj + 1], 2);
    merge<MODE>(kb, ki, kx, rb, ri, 0.0f);
    const int p = owned_point(jj, gid, tig);
    float b0 = my_b[p], x0 = my_x[p];
    int i0 = my_i[p];
    merge<MODE>(b0, i0, x0, kb, ki, kx);
    my_b[p] = b0;
    my_i[p] = i0;
    my_x[p] = x0;
  }
}

// workset: the group's (least root, first index at that root, second-least
// root) per point, what a running minimum over every rooted score in
// ascending order gives (strictly lower replaces the best, otherwise
// lower replaces the second), with the roots taken late.  Pass 1 turns the sums into squares
// sq = max((p2 - 2 dot) + c2, 0) in place and keeps the least and second-
// least square s1 <= s2 of each point (all-reduced over the quad): sqrtf
// is monotone, so the roots are sqrtf(s1) and sqrtf(s2).  Pass 2 finds the
// first centroid whose root equals sqrtf(s1): one whose square equals s1,
// unless a square in (s1, s1 (1 + 2^-19)] exists in the warp (two
// different squares can round to one root); then those are rooted.  The
// quad min-reduces the index, and the lane's 4 results merge into the
// warp's candidates.
__device__ __forceinline__ void fold_workset(
    float (&acc)[8][4][4], const float (&cc)[8], const bool (&ok)[8],
    const float* s_p2, int g, int gid, int tig, float* my_b, int* my_i,
    float* my_x) {
  const float inf = __int_as_float(0x7f800000);
  float s1[16], s2[16];
#pragma unroll
  for (int pt = 0; pt < 16; ++pt) {
    const float p2 = s_p2[(pt >> 1) * 16 + gid + 8 * (pt & 1)];
    s1[pt] = inf;
    s2[pt] = inf;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float& v = KM_ACC(pt, q);
      v = ok[q] ? fmaxf(sq_of(v, cc[q], p2), 0.0f) : inf;
      s2[pt] = fminf(s2[pt], fmaxf(s1[pt], v));
      s1[pt] = fminf(s1[pt], v);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int pt = 0; pt < 16; ++pt) {
      const float t1 = __shfl_xor_sync(kFull, s1[pt], off);
      const float t2 = __shfl_xor_sync(kFull, s2[pt], off);
      s2[pt] = fminf(fminf(s2[pt], t2), fmaxf(s1[pt], t1));
      s1[pt] = fminf(s1[pt], t1);
    }
  }
  int ix[16];
  bool rare = false;
#pragma unroll
  for (int pt = 0; pt < 16; ++pt) {
    const float lim = fmaxf(__fmul_ru(s1[pt], 1.0f + 0x1p-19f), 1e-30f);
    ix[pt] = 0x7fffffff;
#pragma unroll
    for (int q = 7; q >= 0; --q) {
      const float v = KM_ACC(pt, q);
      if (ok[q] && v == s1[pt]) ix[pt] = KM_CENT(q);
      rare |= ok[q] && v != s1[pt] && v <= lim;
    }
  }
  if (__any_sync(kFull, rare)) {
#pragma unroll
    for (int pt = 0; pt < 16; ++pt) {
      const float r1 = sqrtf(s1[pt]);
      const float lim = fmaxf(__fmul_ru(s1[pt], 1.0f + 0x1p-19f), 1e-30f);
#pragma unroll
      for (int q = 7; q >= 0; --q) {
        const float v = KM_ACC(pt, q);
        if (ok[q] && v <= lim && sqrtf(v) == r1) ix[pt] = KM_CENT(q);
      }
    }
  }
  // reduce-scatter of the index; s1 and s2 are the quad's already
  float a1[8], a2[8];
  int i8[8];
  const bool odd1 = tig & 1;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    a1[jj] = odd1 ? s1[2 * jj + 1] : s1[2 * jj];
    a2[jj] = odd1 ? s2[2 * jj + 1] : s2[2 * jj];
    const int ri =
        __shfl_xor_sync(kFull, odd1 ? ix[2 * jj] : ix[2 * jj + 1], 1);
    i8[jj] = min(odd1 ? ix[2 * jj + 1] : ix[2 * jj], ri);
  }
  const bool odd2 = tig & 2;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int ri =
        __shfl_xor_sync(kFull, odd2 ? i8[2 * jj] : i8[2 * jj + 1], 2);
    const int ki = min(odd2 ? i8[2 * jj + 1] : i8[2 * jj], ri);
    const float kb = sqrtf(odd2 ? a1[2 * jj + 1] : a1[2 * jj]);
    const float kx = sqrtf(odd2 ? a2[2 * jj + 1] : a2[2 * jj]);
    const int p = owned_point(jj, gid, tig);
    float b0 = my_b[p], x0 = my_x[p];
    int i0 = my_i[p];
    merge<kWorkset>(b0, i0, x0, kb, ki, kx);
    my_b[p] = b0;
    my_i[p] = i0;
    my_x[p] = x0;
  }
}
#undef KM_ACC
#undef KM_CENT

// Scores on the tensor cores (the first, assign and workset modes), 3xTF32
// mma.sync m16n8k8: warp w takes groups w, w + kWarps, ... of 32
// centroids against all 128 points of the tile, as 8 m-tiles of 16 points
// x 4 n-tiles of 8 centroids (128 f32 sums a lane).  Per 8-dim step a lane
// loads its B fragments (two 16-byte loads from the fragment-ordered
// centroids) and splits them once, then per kMtGroup m-tiles loads and
// splits their A fragments from the permuted tile and runs the 3 products
// of each (m-tile, n-tile) term by term, small terms first, so that
// independent products hide the tensor cores' latency (one block of 8
// warps per SM leaves 2 warps a scheduler to hide it).  After the group's
// last step fold_scores or fold_workset turns the sums into candidates
// and merges them into the warp's row of cand_*.
template <int MODE>
__device__ __forceinline__ void score_tc(
    const float* tile_s, const float* __restrict__ points, size_t row0,
    int n, int k, int d, const float* __restrict__ cent,
    const float* __restrict__ c2, float* cent_s, const float* s_p2,
    const Plan& plan, float* cand_b, int* cand_i, float* cand_x) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int ngroups = plan.kpad / kGroup;
  const int nsuper = (ngroups + kWarps - 1) / kWarps;
  const float inf = __int_as_float(0x7f800000);
  float* my_b = cand_b + warp * kTile;
  int* my_i = cand_i + warp * kTile;
  float* my_x = cand_x + warp * kTile;
  for (int p = lane; p < kTile; p += 32) {
    my_b[p] = inf;
    my_i[p] = 0x7fffffff;
    my_x[p] = MODE == kWorkset ? inf : 0.0f;
  }
  __syncwarp();
  for (int sg = 0; sg < nsuper; ++sg) {
    const int g = sg * kWarps + warp;
    const bool has = g < ngroups;  // warp-uniform
    float acc[8][4][4];
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    for (int j0 = 0; j0 < d; j0 += plan.dch) {
      const int len = min(plan.dch, d - j0);
      const int nst = (len + 7) / 8;
      const float* slab;
      if (plan.cent_res) {
        slab = cent_s + static_cast<size_t>(g) * pad8(d) * kGroup;
      } else {
        __syncthreads();
        stage_frag(cent_s, cent, k, d, sg * kWarps * kGroup, kWarps, j0, len);
        __syncthreads();
        slab = cent_s + static_cast<size_t>(warp) * nst * 8 * kGroup;
      }
      if (has) {
        for (int st = 0; st < nst; ++st) {
          const float4* bp =
              reinterpret_cast<const float4*>(slab + (st * 32 + lane) * 8);
          const float4 b01 = bp[0];
          const float4 b23 = bp[1];
          const float bv[8] = {b01.x, b01.y, b01.z, b01.w,
                               b23.x, b23.y, b23.z, b23.w};
          uint32_t bh[8], bl[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) split_tf32(bv[e], bh[e], bl[e]);
          const int ja = j0 + st * 8 + tig;   // dims ja and ja + 4
          const bool in0 = ja < d;
          const bool in1 = ja + 4 < d;
#pragma unroll
          for (int m0 = 0; m0 < 8; m0 += kMtGroup) {
            // A fragments of kMtGroup m-tiles (points m*16 + gid, + 8)
            uint32_t ah[kMtGroup][4], al[kMtGroup][4];
#pragma unroll
            for (int m = 0; m < kMtGroup; m += 2) {
              // m-tiles m0 + m and m0 + m + 1: tile slots gid * 16 + 2 mt
              // + h, four adjacent floats for each of dims ja and ja + 4
              float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f), w = u;
              if (tile_s != nullptr) {
                const float* t0 = tile_s + static_cast<size_t>(ja) *
                                               kTileStride + gid * 16 +
                                  2 * (m0 + m);
                if (in0) u = *reinterpret_cast<const float4*>(t0);
                if (in1)
                  w = *reinterpret_cast<const float4*>(t0 + 4 * kTileStride);
              } else {
                const size_t last = static_cast<size_t>(n) - 1;
                const int r = (m0 + m) * 16 + gid;
                const float* p0 = points + min(row0 + r, last) * d;
                const float* p1 = points + min(row0 + r + 8, last) * d;
                const float* p2 = points + min(row0 + r + 16, last) * d;
                const float* p3 = points + min(row0 + r + 24, last) * d;
                if (in0)
                  u = make_float4(__ldg(p0 + ja), __ldg(p1 + ja),
                                  __ldg(p2 + ja), __ldg(p3 + ja));
                if (in1)
                  w = make_float4(__ldg(p0 + ja + 4), __ldg(p1 + ja + 4),
                                  __ldg(p2 + ja + 4), __ldg(p3 + ja + 4));
              }
              split_tf32(u.x, ah[m][0], al[m][0]);
              split_tf32(u.y, ah[m][1], al[m][1]);
              split_tf32(w.x, ah[m][2], al[m][2]);
              split_tf32(w.y, ah[m][3], al[m][3]);
              split_tf32(u.z, ah[m + 1][0], al[m + 1][0]);
              split_tf32(u.w, ah[m + 1][1], al[m + 1][1]);
              split_tf32(w.z, ah[m + 1][2], al[m + 1][2]);
              split_tf32(w.w, ah[m + 1][3], al[m + 1][3]);
            }
            // term by term over the m-tiles and n-tiles, so 4 kMtGroup
            // independent products lie between two into one sum
#pragma unroll
            for (int m = 0; m < kMtGroup; ++m)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_tf32(acc[m0 + m][nt], al[m], bh[2 * nt], bh[2 * nt + 1]);
#pragma unroll
            for (int m = 0; m < kMtGroup; ++m)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_tf32(acc[m0 + m][nt], ah[m], bl[2 * nt], bl[2 * nt + 1]);
#pragma unroll
            for (int m = 0; m < kMtGroup; ++m)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_tf32(acc[m0 + m][nt], ah[m], bh[2 * nt], bh[2 * nt + 1]);
          }
        }
      }
    }
    if (!has) continue;
    // c2 of the lane's 8 centroids (KM_CENT order)
    float cc[8];
    bool ok[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = g * kGroup + (q >> 1) * 8 + 2 * tig + (q & 1);
      ok[q] = c < k;
      cc[q] = ok[q] ? __ldg(c2 + c) : 0.0f;
    }
    if (MODE == kWorkset)
      fold_workset(acc, cc, ok, s_p2, g, gid, tig, my_b, my_i, my_x);
    else
      fold_scores<MODE>(acc, cc, ok, g, gid, tig, my_b, my_i, my_x);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
kmeans_kernel(const float* __restrict__ points,
              const float* __restrict__ cent, const float* __restrict__ c2,
              const int* __restrict__ prev, const float* __restrict__ active,
              const float* __restrict__ padm, int* __restrict__ assign_out,
              float* __restrict__ dbest_out, float* __restrict__ dsec_out,
              float* __restrict__ partial, float* __restrict__ pcounts,
              int n, int k, int d, Plan plan) {
  extern __shared__ __align__(16) float smem[];
  int* s_asg = reinterpret_cast<int*>(smem);
  float* s_nt = smem + kTile;
  float* s_best = smem + 2 * kTile;
  float* s_w = smem + 3 * kTile;
  float* s_p2 = smem + 4 * kTile;
  float* cand_b = smem + kPointArrays * kTile;  // [warp][point]
  int* cand_i = reinterpret_cast<int*>(cand_b + kWarps * kTile);
  float* cand_x = cand_b + 2 * kWarps * kTile;
  float* cent_s = cand_b + 3 * kWarps * kTile;
  float* next = cent_s + plan.cent_floats;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int stride = plan.stride;
  float* my_partial = partial + static_cast<size_t>(blockIdx.x) * k * stride;
  float* my_counts = pcounts + static_cast<size_t>(blockIdx.x) * k;
  float* acc = my_partial;
  float* cnt = my_counts;
  if (plan.acc_s) {
    acc = next;
    cnt = next + static_cast<size_t>(k) * stride;
    next = acc + acc_floats(k, stride);
  }
  // the point tiles, transposed: tile[j * kTileStride + p]
  const size_t tile_floats = static_cast<size_t>(d) * kTileStride;
  float* tiles = plan.tile_s ? next : nullptr;

  for (size_t i = tid; i < static_cast<size_t>(k) * stride; i += kThreads)
    acc[i] = 0.0f;
  for (int i = tid; i < k; i += kThreads) cnt[i] = 0.0f;
  if (plan.cent_res) {
    if constexpr (kTensorCores<MODE>())
      stage_frag(cent_s, cent, k, d, 0, plan.kpad / kGroup, 0, d);
    else
      stage(cent_s, cent, k, d, 0, plan.kpad / kGroup, 0, d);
  }
  __syncthreads();

  const int ntiles = (n + kTile - 1) / kTile;
  if (plan.tile_s == 2 && blockIdx.x < ntiles)
    load_tile<kTensorCores<MODE>()>(tiles, points, blockIdx.x, n, d);
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = static_cast<size_t>(tile) * kTile;
    const int rows = min(kTile, n - static_cast<int>(row0));
    float* tile_s = nullptr;
    if (plan.tile_s) {
      tile_s = tiles + buf * tile_floats;
      if (plan.tile_s == 1)
        load_tile<kTensorCores<MODE>()>(tile_s, points, tile, n, d);
      cp_async_wait_all();
      __syncthreads();
      // the other buffer was released by the barrier: prefetch into it
      if (plan.tile_s == 2 && tile + gridDim.x < ntiles)
        load_tile<kTensorCores<MODE>()>(tiles + (buf ^ 1) * tile_floats,
                                        points, tile + gridDim.x, n, d);
      if (plan.tile_s == 2) buf ^= 1;
    }
    if (MODE == kWorkset) {
      // |p|^2 of each point of the tile, fmaf over ascending dims; thread
      // t reads tile position t, which holds row r (tile_pos(r) == t)
      if (tid < kTile) {
        const int r = (tid & 15) * 8 + (tid >> 4);
        const float* pr = points + static_cast<size_t>(
            min(row0 + r, static_cast<size_t>(n) - 1)) * d;
        float a = 0.0f;
        for (int j = 0; j < d; ++j) {
          const float v = tile_s != nullptr
                              ? tile_s[static_cast<size_t>(j) * kTileStride + tid]
                              : __ldg(pr + j);
          a = fmaf(v, v, a);
        }
        s_p2[r] = a;
      }
      __syncthreads();
    }
    if constexpr (kTensorCores<MODE>())
      score_tc<MODE>(tile_s, points, row0, n, k, d, cent, c2, cent_s, s_p2,
                     plan, cand_b, cand_i, cand_x);
    else
      score_fma<MODE>(tile_s, points, row0, n, k, d, cent, c2, cent_s, plan,
                      cand_b, cand_i, cand_x);
    __syncthreads();

    // one thread per point: merge the warps' candidates, write the rows
    if (tid < rows) {
      float b = cand_b[tid];
      int a = cand_i[tid];
      float xx = cand_x[tid];
      for (int w = 1; w < kWarps; ++w)
        merge<MODE>(b, a, xx, cand_b[w * kTile + tid],
                    cand_i[w * kTile + tid], cand_x[w * kTile + tid]);
      const size_t row = row0 + tid;
      float wt = 1.0f;
      if (MODE == kAssign) assign_out[row] = a;
      if (MODE == kWorkset) {
        if (!(active[row] > 0.0f)) a = prev[row];
        assign_out[row] = a;
        dbest_out[row] = b;
        dsec_out[row] = xx;
        wt = padm[row];
      }
      if (MODE == kSplit) wt = 1.0f / xx;
      s_asg[tid] = a;
      s_nt[tid] = MODE == kWorkset ? 1.0f : xx;
      s_best[tid] = b;
      s_w[tid] = wt;
    }
    __syncthreads();

    // keyed reduce: cluster row c belongs to warp c % kWarps, whose lanes
    // split its dims and add the warp's points in tile order.  A ballot
    // over 32 points at a time finds the warp's points and the tied ones.
    for (int base = 0; base < rows; base += 32) {
      const int p = base + lane;
      const bool valid = p < rows;
      const int a = valid ? s_asg[p] : -1;
      const float w = valid ? s_w[p] : 0.0f;
      const bool tied = (MODE == kFast || MODE == kSplit) && valid &&
                        s_nt[p] > 1.0f;
      const bool mine =
          !tied && a >= 0 && a < k && a % kWarps == warp && w != 0.0f;
      unsigned todo = __ballot_sync(kFull, mine || tied);
      const unsigned tied_bits = __ballot_sync(kFull, tied);
      while (todo) {
        const int bit = __ffs(todo) - 1;
        todo &= todo - 1;
        const int q = base + bit;
        const float wq = __shfl_sync(kFull, w, bit);
        const int aq = __shfl_sync(kFull, a, bit);
        const float* pr = points + (row0 + q) * d;
        const float* pt =
            tile_s != nullptr ? tile_s + tile_pos<kTensorCores<MODE>()>(q)
                              : pr;
        const int pstep = tile_s != nullptr ? kTileStride : 1;
        if ((tied_bits >> bit) & 1u) {
          // exact ties: each lane rescores one of the warp's clusters with
          // the scoring loop's arithmetic; the warp adds the tied rows in
          // ascending cluster order
          const float bestq = s_best[q];
          for (int c0 = warp; c0 < k; c0 += kWarps * 32) {
            const int c = c0 + kWarps * lane;
            const float* cr = cent + static_cast<size_t>(c) * d;
            const bool hit =
                c < k && score_of(dot_of(pr, cr, d), __ldg(c2 + c)) == bestq;
            unsigned hits = __ballot_sync(kFull, hit);
            while (hits) {
              const int c_hit = c0 + kWarps * (__ffs(hits) - 1);
              hits &= hits - 1;
              warp_add_row(acc + static_cast<size_t>(c_hit) * stride,
                           cnt + c_hit, pt, pstep, d, wq, lane);
            }
          }
        } else {
          warp_add_row(acc + static_cast<size_t>(aq) * stride, cnt + aq, pt,
                       pstep, d, wq, lane);
        }
      }
    }
    __syncthreads();
  }

  if (plan.acc_s) {
    for (size_t i = tid; i < static_cast<size_t>(k) * stride; i += kThreads)
      my_partial[i] = acc[i];
    for (int i = tid; i < k; i += kThreads) my_counts[i] = cnt[i];
  }
}

// c2[c] = |centroid c|^2, fmaf over ascending dims.
__global__ void centroid_norms_kernel(const float* __restrict__ cent, int k,
                                      int d, float* __restrict__ c2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < k) {
    const float* row = cent + static_cast<size_t>(c) * d;
    c2[c] = dot_of(row, row, d);
  }
}

// sums and counts = the blocks' partials added in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ pcounts,
                                       int grid, int k, int d, int stride,
                                       float* __restrict__ sums,
                                       float* __restrict__ counts) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t kd = static_cast<size_t>(k) * d;
  if (i < kd) {
    const size_t c = i / d;
    const size_t j = i - c * d;
    float s = 0.0f;
    for (int b = 0; b < grid; ++b)
      s += partial[(static_cast<size_t>(b) * k + c) * stride + j];
    sums[i] = s;
  } else if (i < kd + k) {
    const size_t c = i - kd;
    float s = 0.0f;
    for (int b = 0; b < grid; ++b) s += pcounts[static_cast<size_t>(b) * k + c];
    counts[c] = s;
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*,
                         const int*, const float*, const float*, int*,
                         float*, float*, float*, float*, int, int, int, Plan);

KernelFn kernel_for(int mode) {
  switch (mode) {
    case kFirst: return kmeans_kernel<kFirst>;
    case kFast: return kmeans_kernel<kFast>;
    case kSplit: return kmeans_kernel<kSplit>;
    case kAssign: return kmeans_kernel<kAssign>;
    case kWorkset: return kmeans_kernel<kWorkset>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Blocks of the main kernel for this shape (the wrapper sizes the scratch
// buffer from it), and the floats of scratch the launch needs.
int kmeans_grid(int mode, int n, int k, int d, int* grid, int64_t* scratch) {
  KernelFn fn = kernel_for(mode);
  if (fn == nullptr || n < 0 || k < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(k, d);
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
  *scratch = static_cast<int64_t>(k) +
             static_cast<int64_t>(*grid) * k * (plan.stride + 1);
  return static_cast<int>(cudaGetLastError());
}

// scratch: c2 (k) | block counts (grid * k) | block sums (grid * k * stride)
int kmeans_launch(int mode, const void* points, const void* cent,
                  const void* prev, const void* active, const void* padm,
                  void* assign, void* dbest, void* dsec, void* scratch,
                  void* sums, void* counts, int n, int k, int d, int grid,
                  void* stream) {
  KernelFn fn = kernel_for(mode);
  if (fn == nullptr || n < 0 || k < 1 || d < 1 || grid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(k, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* c2 = static_cast<float*>(scratch);
  float* pcounts = c2 + k;
  float* partial = pcounts + static_cast<size_t>(grid) * k;
  centroid_norms_kernel<<<(k + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(cent), k, d, c2);
  if (grid > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<grid, kThreads, plan.smem, s>>>(
        static_cast<const float*>(points), static_cast<const float*>(cent),
        c2, static_cast<const int*>(prev), static_cast<const float*>(active),
        static_cast<const float*>(padm), static_cast<int*>(assign),
        static_cast<float*>(dbest), static_cast<float*>(dsec), partial,
        pcounts, n, k, d, plan);
  }
  const size_t total = static_cast<size_t>(k) * d + k;
  reduce_partials_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                           s>>>(partial, pcounts, grid, k, d, plan.stride,
                                static_cast<float*>(sums),
                                static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
