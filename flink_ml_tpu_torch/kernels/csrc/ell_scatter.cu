// Hand-written Hopper (sm_90a) kernels for the ELL static routing of the
// mixed-layout linear trainers (flink_ml_tpu_torch/ops/ell_scatter.py).
//
// The weight table is viewed as (rows, 128): table row `row` holds weights
// [row*128, row*128+128).  The host layout (ops/ell_scatter.py::ell_layout)
// gives every table row up to 128 slots, sorted by the lane they hit:
//   src[row, s]  batch row charged by slot s (`batch` for a pad slot)
//   pos[row, l]  P = (# kept slots with lane <= l) - 1, clamped at 0
//   mask[row, l] 1.0 where P >= 0 (lane l or an earlier lane has a slot)
// and, once per fit, ops/ell_scatter.py::sample_routing inverts it into a
// sample-major routing:
//   route_w[t, b]   weight index row*128 + lane of sample b's t-th in-grid
//                   slot, in ascending grid position; -1 after the last
//   route_val[t, b] that slot's value (the generic sparse layout only)
//
// Three kernels:
//
// 1. ell_margin: replaces flink_ml_tpu/ops/ell_scatter.py::ell_margin_fused
//    (_margin_kernel).  m[b] = sum_t w[route_w[t, b]] * route_val[t, b] for
//    b < batch, 0 in the pad [batch, m_len); a route entry outside
//    [0, n_w) (the -1 after a sample's last slot) reads 0.  The TPU kernel accumulated
//    per-sample sums with one-hot MXU contractions because a w[cat] gather
//    is transaction-bound there; on the H100 w (4 MB at 2^20 features) fits
//    the 50 MB L2 and a gather is one L2 transaction, so each thread owns
//    one sample: it issues all of its (coalesced) route loads, then all of
//    its weight gathers, then adds them in column order with
//    __fmul_rn/__fadd_rn (no FMA contraction).  No atomics and no scan of
//    table rows: the sum order is fixed, so the kernel is deterministic and
//    equals the plain version bit for bit, and it writes every entry of m
//    (no memset).  Bound on the H100: bytes (the routing, nnz*batch*4
//    ~3.3 MB at batch 2^15, plus the distinct weights touched, ~2.3 MB:
//    ~1.7 us at 3.35 TB/s); what it meets first is the ~820k gathers, one
//    L2 transaction each, and the route loads of only 8 warps an SM (one
//    thread a sample), as scripts/ell_phase_times.py shows.
// 2. ell_scatter_apply_fused: replaces ::ell_scatter_apply_fused
//    (_fused_kernel, _csum_pick_tail).  out = w + scatter(-lr*val*r_ext[src]).
//    The gather is a direct __ldg (r_ext is ~33k floats at batch 2^15 and
//    stays in L2), so values are exact f32 (the TPU "highest" precision).
//    The scatter is the TPU kernel's algorithm unchanged: per row, the
//    inclusive lane cumsum C of u (7 shifted adds: 5 warp shuffles, 2
//    register steps), the pick G[l] = C[pos[l]] * mask[l], and
//    out[l] = (w[l] + G[l]) - G[l-1].  No random writes, no atomics:
//    deterministic, and equal to the plain version bit for bit.  Bound:
//    bytes (src, pos, mask read, w read and written: 20 B a grid slot,
//    ~21 MB per step at 2^20 features).  Design: one warp per table row,
//    8 rows per 256-thread block; the 8192 rows of the main path are 1024
//    blocks, one wave on 132 SMs.  Every load of the row (src, pos, mask,
//    w and val; 16-20 coalesced 128-byte loads a warp) is issued at the
//    top, where the first design issued them one dependent phase after
//    another (src, then the gather, then pos and mask, then w), so a warp
//    waits on two memory round trips (the row, then the r_ext gather)
//    instead of four.  A persistent grid over a ring of bulk-copied rows
//    was built and measured slower at this shape (scripts/
//    ell_ring_variant.cu, scripts/ell_phase_times.py): it serializes up to
//    4 row groups a block where this grid has every row in flight.
// 3. ell_scatter_apply: replaces ::ell_scatter_apply (_kernel,
//    _csum_pick_tail), the pair path for grids whose row count is not a
//    multiple of 8: the same cumsum/pick/difference on a precomputed
//    per-slot update upd (rows, 128), one warp per table row, kPairRows
//    rows per block.  Bound: bytes (upd, pos, mask, w read, w written: 20
//    B a slot, 2.6 MB at 1001 rows, ~0.8 us at 3.35 TB/s); what it meets
//    is the launch and the memory round trips a warp waits on.  So every
//    load of the row (upd, pos, mask, w: 16 coalesced 128-byte loads a
//    warp) is issued at the top and the warp waits on one round trip,
//    where the first design loaded upd, ran the cumsum, and only then
//    loaded pos and mask, and then w (three trips in series).
//
// Every pointer may be any device address; `out` may alias `w` (a row's w
// is read before its out is written, and rows are disjoint between
// warps).  Each launcher returns cudaGetLastError() so the caller sees a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 128;             // slots (and lanes) per table row
constexpr int kWarps = 8;               // table rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = kWidth / 32;   // elements of a row per thread
constexpr unsigned kFull = 0xffffffffu;

constexpr int kPairRows = 8;            // table rows per pair block
constexpr int kMarginThreads = 128;     // samples per margin block
constexpr int kMarginChunk = 32;        // route columns in flight a thread

// x[i] += x[i - k] for every element i of the row (adds 0 where i < k),
// 0 < k < 32.  Reads only values shuffled before any update.
__device__ __forceinline__ void shifted_add(float (&x)[kPerLane], int lane,
                                            int k) {
  float sh[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    sh[j] = __shfl_sync(kFull, x[j], (lane - k) & 31);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    x[j] += lane >= k ? sh[j] : (j > 0 ? sh[j - 1] : 0.0f);
}

// Inclusive cumsum along the 128 elements of the row, in the order of the
// TPU kernel's 7 shifted adds (k = 1, 2, ..., 64).
__device__ __forceinline__ void row_cumsum(float (&x)[kPerLane], int lane) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) shifted_add(x, lane, k);
  // k = 32: element i - 32 is register j - 1 of the same lane
  x[3] += x[2];
  x[2] += x[1];
  x[1] += x[0];
  x[0] += 0.0f;
  // k = 64: register j - 2 of the same lane
  x[3] += x[1];
  x[2] += x[0];
  x[1] += 0.0f;
  x[0] += 0.0f;
}

// The scatter tail of kernels 2 and 3 on a row held in registers: the
// cumsum of u, the pick G[l] = C[pos[l]] * mask[l] through the warp's
// shared row, and out[l] = (w[l] + G[l]) - G[l-1], in the plain version's
// order of rounded operations.
__device__ __forceinline__ void scatter_tail(
    float (&u)[kPerLane], const int (&pos)[kPerLane],
    const float (&mask)[kPerLane], const float (&w)[kPerLane], float* out,
    int64_t base, int lane, float* csum) {
  row_cumsum(u, lane);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) csum[lane + 32 * j] = u[j];
  __syncwarp();
  float g[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int p = min(max(pos[j], 0), kWidth - 1);
    g[j] = __fmul_rn(csum[p], mask[j]);
  }
  float sh[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    sh[j] = __shfl_sync(kFull, g[j], (lane - 1) & 31);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float gs = lane >= 1 ? sh[j] : (j > 0 ? sh[j - 1] : 0.0f);
    out[base + lane + 32 * j] = __fsub_rn(__fadd_rn(w[j], g[j]), gs);
  }
}

// ---------------------------------------------------------------------------
// 1. the margin: one thread per sample
// ---------------------------------------------------------------------------

template <bool kVal>
__global__ void __launch_bounds__(kMarginThreads)
ell_margin_kernel(const float* __restrict__ w, int n_w,
                  const int* __restrict__ route_w,
                  const float* __restrict__ route_val,
                  float* __restrict__ m, int nnz, int batch, int m_len) {
  const int b = blockIdx.x * kMarginThreads + threadIdx.x;
  if (b >= m_len) return;
  float acc = 0.0f;
  if (b < batch) {
    for (int t0 = 0; t0 < nnz; t0 += kMarginChunk) {
      int idx[kMarginChunk];
      float v[kMarginChunk];
#pragma unroll
      for (int j = 0; j < kMarginChunk; ++j) {
        const int64_t at = static_cast<int64_t>(t0 + j) * batch + b;
        idx[j] = t0 + j < nnz ? __ldg(route_w + at) : -1;
        if (kVal) v[j] = t0 + j < nnz ? __ldg(route_val + at) : 0.0f;
      }
      float g[kMarginChunk];
#pragma unroll
      for (int j = 0; j < kMarginChunk; ++j)
        g[j] = static_cast<unsigned>(idx[j]) < static_cast<unsigned>(n_w)
                   ? __ldg(w + idx[j]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kMarginChunk; ++j) {
        if (t0 + j < nnz)
          acc = __fadd_rn(acc, kVal ? __fmul_rn(g[j], v[j]) : g[j]);
      }
    }
  }
  m[b] = acc;
}

// ---------------------------------------------------------------------------
// 2. the fused scatter: one warp per table row, every row load hoisted
// ---------------------------------------------------------------------------

template <bool kVal>
__global__ void __launch_bounds__(kThreads)
ell_scatter_fused_kernel(const float* w, const float* __restrict__ r_ext,
                         int r_len, const int* __restrict__ src,
                         const int* __restrict__ pos,
                         const float* __restrict__ mask,
                         const float* __restrict__ val, float neg_lr,
                         float* out, int rows) {
  __shared__ float csum_rows[kWarps][kWidth];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;              // the whole warp leaves together
  const int64_t base = static_cast<int64_t>(row) * kWidth;
  // every load of the row at once: they depend on nothing
  int s_src[kPerLane], s_pos[kPerLane];
  float s_mask[kPerLane], s_w[kPerLane], s_val[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int l = lane + 32 * j;
    s_src[j] = __ldg(src + base + l);
    s_pos[j] = __ldg(pos + base + l);
    s_mask[j] = __ldg(mask + base + l);
    s_w[j] = w[base + l];
    if (kVal) s_val[j] = __ldg(val + base + l);
  }
  float u[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int m = s_src[j];
    u[j] = static_cast<unsigned>(m) < static_cast<unsigned>(r_len)
               ? __ldg(r_ext + m) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    u[j] = __fmul_rn(neg_lr, u[j]);
    if (kVal) u[j] = __fmul_rn(u[j], s_val[j]);
  }
  scatter_tail(u, s_pos, s_mask, s_w, out, base, lane, csum_rows[warp]);
}


// ---------------------------------------------------------------------------
// 3. the pair scatter: one warp per table row, every row load hoisted
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPairRows * 32)
ell_scatter_pair_kernel(const float* w, const float* __restrict__ upd,
                        const int* __restrict__ pos,
                        const float* __restrict__ mask, float* out,
                        int rows) {
  __shared__ float csum_rows[kPairRows][kWidth];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPairRows + warp;
  if (row >= rows) return;              // the whole warp leaves together
  const int64_t base = static_cast<int64_t>(row) * kWidth;
  // every load of the row at once.  `out` may alias `w`, so w is not
  // __restrict__ and the compiler cannot move its load above the stores
  // itself: loading it here is safe because this warp reads its own row of
  // w before it writes that row, and no other warp touches the row.
  float u[kPerLane], s_mask[kPerLane], s_w[kPerLane];
  int s_pos[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int l = lane + 32 * j;
    u[j] = __ldg(upd + base + l);
    s_pos[j] = __ldg(pos + base + l);
    s_mask[j] = __ldg(mask + base + l);
    s_w[j] = w[base + l];
  }
  scatter_tail(u, s_pos, s_mask, s_w, out, base, lane, csum_rows[warp]);
}

inline int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

int ell_margin_launch(const void* w, int n_w, const void* route_w,
                      const void* route_val, void* m, int nnz, int batch,
                      int m_len, void* stream) {
  if (m_len > 0) {
    const int blocks = (m_len + kMarginThreads - 1) / kMarginThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route_val != nullptr) {
      ell_margin_kernel<true><<<blocks, kMarginThreads, 0, st>>>(
          static_cast<const float*>(w), n_w,
          static_cast<const int*>(route_w),
          static_cast<const float*>(route_val), static_cast<float*>(m), nnz,
          batch, m_len);
    } else {
      ell_margin_kernel<false><<<blocks, kMarginThreads, 0, st>>>(
          static_cast<const float*>(w), n_w,
          static_cast<const int*>(route_w), nullptr, static_cast<float*>(m),
          nnz, batch, m_len);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int ell_scatter_fused_launch(const void* w, const void* r_ext, int r_len,
                             const void* src, const void* pos,
                             const void* mask, const void* val, float lr,
                             void* out, int rows, void* stream) {
  if (rows > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (val != nullptr) {
      ell_scatter_fused_kernel<true><<<blocks_for(rows), kThreads, 0, st>>>(
          static_cast<const float*>(w), static_cast<const float*>(r_ext),
          r_len, static_cast<const int*>(src), static_cast<const int*>(pos),
          static_cast<const float*>(mask), static_cast<const float*>(val),
          -lr, static_cast<float*>(out), rows);
    } else {
      ell_scatter_fused_kernel<false><<<blocks_for(rows), kThreads, 0, st>>>(
          static_cast<const float*>(w), static_cast<const float*>(r_ext),
          r_len, static_cast<const int*>(src), static_cast<const int*>(pos),
          static_cast<const float*>(mask), nullptr, -lr,
          static_cast<float*>(out), rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int ell_scatter_pair_launch(const void* w, const void* upd, const void* pos,
                            const void* mask, void* out, int rows,
                            void* stream) {
  if (rows > 0) {
    ell_scatter_pair_kernel<<<(rows + kPairRows - 1) / kPairRows,
                              kPairRows * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const float*>(upd),
        static_cast<const int*>(pos), static_cast<const float*>(mask),
        static_cast<float*>(out), rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
