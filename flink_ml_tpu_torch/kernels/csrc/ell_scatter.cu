// Hand-written Hopper (sm_90a) kernels for the ELL static routing of the
// mixed-layout linear trainers (flink_ml_tpu_torch/ops/ell_scatter.py).
//
// The weight table is viewed as (rows, 128): table row `row` holds weights
// [row*128, row*128+128).  The host layout (ops/ell_scatter.py::ell_layout)
// gives every table row up to 128 slots, sorted by the lane they hit:
//   src[row, s]  batch row charged by slot s (`batch` for a pad slot)
//   pos[row, l]  P = (# kept slots with lane <= l) - 1, clamped at 0
//   mask[row, l] 1.0 where P >= 0 (lane l or an earlier lane has a slot)
//
// Three kernels, one warp per table row, 8 rows per 256-thread block.
// Element i of a row lives in lane (i % 32), register (i / 32) of its warp,
// so every global load and store is 32 consecutive words (coalesced).
//
// 1. ell_margin: replaces flink_ml_tpu/ops/ell_scatter.py::ell_margin_fused
//    (_margin_kernel).  m_ext[src[s]] += w[row*128 + lane(s)] * val[s], with
//    lane(s) = #{l : pos_eff[l] < s}, pos_eff = pos + mask - 1, clamped to
//    127.  The TPU kernel accumulated per-sample sums with one-hot MXU
//    contractions; here each slot issues one atomicAdd into the zeroed
//    margin table.  Bound on the H100: bytes (src, pos, mask read once,
//    w read once: ~16 MB per step at 2^20 features, ~5 us at 3.35 TB/s)
//    plus ~850k atomics spread over 2^15 addresses.  Design: pos_eff of the
//    row sits in shared memory, each slot finds its lane by a 7-step binary
//    search (pos_eff is nondecreasing), and slots past the row's last kept
//    slot (pad slots, whose sum the caller discards) issue no atomic, so no
//    hot spot forms on the pad entry.  The atomics make the summation order
//    vary from run to run: results agree with the plain version to f32
//    rounding, not bitwise.
// 2. ell_scatter_apply_fused: replaces ::ell_scatter_apply_fused
//    (_fused_kernel, _csum_pick_tail).  out = w + scatter(-lr*val*r_ext[src]).
//    The TPU kernel gathered r_ext through a one-hot MXU contraction; here
//    the gather is a direct __ldg (r_ext is ~33k floats at batch 2^15 and
//    stays in L2), so values are exact f32 (the TPU "highest" precision).
//    The scatter is the TPU kernel's algorithm unchanged: per row, the
//    inclusive lane cumsum C of u (7 shifted adds: 5 warp shuffles, 2
//    register steps), the pick G[l] = C[pos[l]] * mask[l] through shared
//    memory, and out[l] = (w[l] + G[l]) - G[l-1].  No random writes, no
//    atomics: the addition order is fixed, so the kernel is deterministic
//    and equals the plain version bit for bit.  Bound: bytes (src, pos,
//    mask read, w read and written: ~20 MB per step at 2^20 features).
// 3. ell_scatter_apply: replaces ::ell_scatter_apply (_kernel), the pair
//    path for grids whose row count is not a multiple of 8: the same
//    cumsum/pick/difference on a precomputed per-slot update upd (rows, 128).
//    Shares csum_pick_tail with kernel 2.  Bound: bytes (~20 MB per step).
//
// Every pointer may be any device address; `out` may alias `w` (each
// element is read and written by the same thread).  Each launcher returns
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 128;             // slots (and lanes) per table row
constexpr int kWarps = 8;               // table rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = kWidth / 32;   // elements of a row per thread
constexpr unsigned kFull = 0xffffffffu;

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

// The scatter tail shared by kernels 2 and 3: cumsum u, pick at pos, mask,
// difference against the previous lane, add to w.
__device__ __forceinline__ void csum_pick_tail(
    float (&u)[kPerLane], const int* __restrict__ pos,
    const float* __restrict__ mask, const float* w, float* out,
    int64_t base, int lane, float* csum) {
  row_cumsum(u, lane);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) csum[lane + 32 * j] = u[j];
  __syncwarp();
  float g[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int l = lane + 32 * j;
    int p = __ldg(pos + base + l);
    p = min(max(p, 0), kWidth - 1);
    g[j] = csum[p] * __ldg(mask + base + l);
  }
  float sh[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    sh[j] = __shfl_sync(kFull, g[j], (lane - 1) & 31);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int l = lane + 32 * j;
    const float gs = lane >= 1 ? sh[j] : (j > 0 ? sh[j - 1] : 0.0f);
    out[base + l] = (w[base + l] + g[j]) - gs;
  }
}

__global__ void __launch_bounds__(kThreads)
ell_margin_kernel(const float* __restrict__ w, const int* __restrict__ src,
                  const int* __restrict__ pos,
                  const float* __restrict__ mask,
                  const float* __restrict__ val, float* __restrict__ m_ext,
                  int rows, int m_len) {
  __shared__ int pos_eff[kWarps][kWidth];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;              // the whole warp leaves together
  const int64_t base = static_cast<int64_t>(row) * kWidth;
  int* pe = pos_eff[warp];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int l = lane + 32 * j;
    pe[l] = __ldg(pos + base + l) + (__ldg(mask + base + l) != 0.0f) - 1;
  }
  __syncwarp();
  // kept slots occupy positions 0 .. pe[127]; the rest are pad slots
  const int kept = pe[kWidth - 1] + 1;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    if (s >= kept) continue;
    const int m = __ldg(src + base + s);
    if (static_cast<unsigned>(m) >= static_cast<unsigned>(m_len)) continue;
    int lo = 0, hi = kWidth;            // first l with pe[l] >= s
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pe[mid] < s) lo = mid + 1; else hi = mid;
    }
    float g = __ldg(w + base + min(lo, kWidth - 1));
    if (val != nullptr) g *= __ldg(val + base + s);
    atomicAdd(m_ext + m, g);
  }
}

__global__ void __launch_bounds__(kThreads)
ell_scatter_fused_kernel(const float* w, const float* __restrict__ r_ext,
                         int r_len, const int* __restrict__ src,
                         const int* __restrict__ pos,
                         const float* __restrict__ mask,
                         const float* __restrict__ val, float neg_lr,
                         float* out, int rows) {
  __shared__ float csum[kWarps][kWidth];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const int64_t base = static_cast<int64_t>(row) * kWidth;
  float u[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    const int m = __ldg(src + base + s);
    const float r = static_cast<unsigned>(m) < static_cast<unsigned>(r_len)
                        ? __ldg(r_ext + m) : 0.0f;
    u[j] = neg_lr * r;
    if (val != nullptr) u[j] *= __ldg(val + base + s);
  }
  csum_pick_tail(u, pos, mask, w, out, base, lane, csum[warp]);
}

__global__ void __launch_bounds__(kThreads)
ell_scatter_pair_kernel(const float* w, const float* __restrict__ upd,
                        const int* __restrict__ pos,
                        const float* __restrict__ mask, float* out,
                        int rows) {
  __shared__ float csum[kWarps][kWidth];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const int64_t base = static_cast<int64_t>(row) * kWidth;
  float u[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) u[j] = __ldg(upd + base + lane + 32 * j);
  csum_pick_tail(u, pos, mask, w, out, base, lane, csum[warp]);
}

inline int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

int ell_margin_launch(const void* w, const void* src, const void* pos,
                      const void* mask, const void* val, void* m_ext,
                      int rows, int m_len, void* stream) {
  if (rows > 0) {
    ell_margin_kernel<<<blocks_for(rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const int*>(src),
        static_cast<const int*>(pos), static_cast<const float*>(mask),
        static_cast<const float*>(val), static_cast<float*>(m_ext), rows,
        m_len);
  }
  return static_cast<int>(cudaGetLastError());
}

int ell_scatter_fused_launch(const void* w, const void* r_ext, int r_len,
                             const void* src, const void* pos,
                             const void* mask, const void* val, float lr,
                             void* out, int rows, void* stream) {
  if (rows > 0) {
    ell_scatter_fused_kernel<<<blocks_for(rows), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const float*>(r_ext),
        r_len, static_cast<const int*>(src), static_cast<const int*>(pos),
        static_cast<const float*>(mask), static_cast<const float*>(val),
        -lr, static_cast<float*>(out), rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int ell_scatter_pair_launch(const void* w, const void* upd, const void* pos,
                            const void* mask, void* out, int rows,
                            void* stream) {
  if (rows > 0) {
    ell_scatter_pair_kernel<<<blocks_for(rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const float*>(upd),
        static_cast<const int*>(pos), static_cast<const float*>(mask),
        static_cast<float*>(out), rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
