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
// CUDA cores; the bytes (points read once, 268 MB) take 0.08 ms.  So the
// kernels are bound by operations, and the design keeps the scores, the
// one-hot and the partial sums out of device memory:
//
// - A block takes tiles of 128 points and walks over tiles b, b + G,
//   b + 2G, ... (G = blocks that fit on the card at once).  The centroids
//   sit in shared memory for the block's life (64 KB at the headline) in
//   groups of 32, laid out [group][dim][32]; warp w scores groups w,
//   w + 8, ...  A lane keeps 4 points x 32 centroids of dot products in
//   registers: per dim it reads its 4 points as one 16-byte load from the
//   transposed point tile and the group's 32 centroid values as 8
//   broadcast 16-byte loads, for 128 FMAs (one point per lane would feed
//   each broadcast value to only 32 FMAs a warp and be bound by shared
//   memory).  The 8 warps' per-point candidates (least
//   score, first index, tie count or second-best) merge in an order-free
//   rule, so the first-index semantics hold.  The next tile streams into
//   a second buffer with cp.async while this one is scored and reduced
//   (one block per SM leaves no other block to hide the load).  Where the
//   centroids do not
//   fit, each 256-centroid slab is staged per tile in 64-dim pieces;
//   where the tile does not fit, lanes read their points from device
//   memory: slower, but no shape is refused.
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
//   score of each of its clusters with the same arithmetic and adds the
//   point where it equals the minimum.
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
constexpr size_t kSmemLimit = 232448;  // 227 KB, Hopper's per-block opt-in

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
  size_t smem;
};

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
  const size_t fixed = (4 + 3 * kWarps) * kTile * sizeof(float);
  const size_t avail = kSmemLimit - fixed;
  size_t used;
  const size_t cent = static_cast<size_t>(p.kpad) * d * sizeof(float);
  if (cent <= avail) {
    p.cent_res = 1;
    p.dch = d;
    used = cent;
  } else {
    p.cent_res = 0;
    p.dch = d < kSlabDims ? d : kSlabDims;
    used = static_cast<size_t>(kWarps) * kGroup * p.dch * sizeof(float);
  }
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

// The root distance of #6, in the order (p2 - 2 * dot) + c2.
__device__ __forceinline__ float dist_of(float dot, float c2, float p2) {
  const float sq = __fadd_rn(__fsub_rn(p2, __fmul_rn(2.0f, dot)), c2);
  return sqrtf(fmaxf(sq, 0.0f));
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
    dst[idx] = c < k ? cent[static_cast<size_t>(c) * d + j0 + j] : 0.0f;
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

// Start copying tile `tile` into dst, transposed (dst[j * kTileStride + r]);
// rows past n are zero.
__device__ void load_tile(float* dst, const float* __restrict__ points,
                          int tile, int n, int d) {
  const size_t row0 = static_cast<size_t>(tile) * kTile;
  const int rows = min(kTile, n - static_cast<int>(row0));
  const float* src = points + row0 * d;
  for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
    const int r = idx / d;
    float* to = dst + static_cast<size_t>(idx - r * d) * kTileStride + r;
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
  for (int j = lane; j < d; j += 32)
    acc[j] += w * p[static_cast<size_t>(j) * pstep];
  if (lane == 0) *cnt += w;
}

// Running minimum over one point's scores, in ascending centroid order:
// the first minimal index, and the count of exact ties (stats modes) or
// the second-best value (workset mode, `x`).
template <int MODE>
__device__ __forceinline__ void take(float v, int c, float& best, int& idx,
                                     float& x) {
  if (MODE == kWorkset) {
    if (v < best) {
      x = best;
      best = v;
      idx = c;
    } else if (v < x) {
      x = v;
    }
  } else {
    if (v < best) {
      best = v;
      idx = c;
      x = 1.0f;
    } else if (v == best) {
      x += 1.0f;
    }
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
  float* cand_b = smem + 4 * kTile;            // [warp][point]
  int* cand_i = reinterpret_cast<int*>(cand_b + kWarps * kTile);
  float* cand_x = cand_b + 2 * kWarps * kTile;
  float* cent_s = cand_b + 3 * kWarps * kTile;
  float* next = cent_s + (plan.cent_res
                              ? static_cast<size_t>(plan.kpad) * d
                              : static_cast<size_t>(kWarps) * kGroup *
                                    plan.dch);
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
  if (plan.cent_res) stage(cent_s, cent, k, d, 0, plan.kpad / kGroup, 0, d);
  __syncthreads();

  const int ngroups = plan.kpad / kGroup;
  const int nsuper = (ngroups + kWarps - 1) / kWarps;
  const int ntiles = (n + kTile - 1) / kTile;
  if (plan.tile_s == 2 && blockIdx.x < ntiles)
    load_tile(tiles, points, blockIdx.x, n, d);
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = static_cast<size_t>(tile) * kTile;
    const int rows = min(kTile, n - static_cast<int>(row0));
    float* tile_s = nullptr;
    if (plan.tile_s) {
      tile_s = tiles + buf * tile_floats;
      if (plan.tile_s == 1) load_tile(tile_s, points, tile, n, d);
      cp_async_wait_all();
      __syncthreads();
      // the other buffer was released by the barrier: prefetch into it
      if (plan.tile_s == 2 && tile + gridDim.x < ntiles)
        load_tile(tiles + (buf ^ 1) * tile_floats, points, tile + gridDim.x,
                  n, d);
      if (plan.tile_s == 2) buf ^= 1;
    }
    // this lane's 4 points: tile rows 4 * lane .. 4 * lane + 3
    const float* prow[kQuad];
#pragma unroll
    for (int i = 0; i < kQuad; ++i)
      prow[i] = points + static_cast<size_t>(min(row0 + kQuad * lane + i,
                                                 static_cast<size_t>(n) - 1)) * d;
    float p2[kQuad];
    float best[kQuad];
    float x[kQuad];
    int idx[kQuad];
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      p2[i] = 0.0f;
      best[i] = __int_as_float(0x7f800000);
      x[i] = MODE == kWorkset ? best[i] : 0.0f;
      idx[i] = 0x7fffffff;
    }
    if (MODE == kWorkset) {
      for (int j = 0; j < d; ++j) {
        const float4 pv = load_quad(tile_s, prow, j, lane);
        p2[0] = fmaf(pv.x, pv.x, p2[0]);
        p2[1] = fmaf(pv.y, pv.y, p2[1]);
        p2[2] = fmaf(pv.z, pv.z, p2[2]);
        p2[3] = fmaf(pv.w, pv.w, p2[3]);
      }
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
              const float v = MODE == kWorkset ? dist_of(dot[i][u], cc, p2[i])
                                               : score_of(dot[i][u], cc);
              take<MODE>(v, c, best[i], idx[i], x[i]);
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
      const bool tied =
          (MODE == kFast || MODE == kSplit) && valid && s_nt[p] > 1.0f;
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
        const float* pt = tile_s != nullptr ? tile_s + q : pr;
        const int pstep = tile_s != nullptr ? kTileStride : 1;
        if ((tied_bits >> bit) & 1u) {
          // exact ties: each lane rescores one of the warp's clusters with
          // the scoring loop's arithmetic; the warp adds the tied rows in
          // ascending cluster order
          const float bestq = s_best[q];
          for (int c0 = warp; c0 < k; c0 += kWarps * 32) {
            const int c = c0 + kWarps * lane;
            const bool hit =
                c < k &&
                score_of(dot_of(pr, cent + static_cast<size_t>(c) * d, d),
                         __ldg(c2 + c)) == bestq;
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
