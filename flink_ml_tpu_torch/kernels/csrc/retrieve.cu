// Hand-written Hopper (sm_90a) kernels for IVF search
// (flink_ml_tpu_torch/ops/retrieve.py): coarse probe selection, the scan of
// the probed posting lists and the top-k, one launch per search.
//
// Replaces flink_ml_tpu/ops/retrieve_pallas.py:
// - flat_kernel: retrieve_flat_fused (_flat_kernel, _merge_topk,
//   _select_first_min).  Squared L2 (|q|^2 + |x|^2) - 2 q.x over f32 rows.
// - pq_kernel: retrieve_pq_fused (_pq_kernel).  Asymmetric distances: the
//   books decoded (cb_q * cb_s), per probe the residual r = q - c[probe]
//   and its table lut[s][c] = sum_t (r[s][t] - book[s][c][t])^2, then
//   sum_s lut[s][code[s]] over the int8 codes of the probed block.
//
// Bit for bit with the plain PyTorch versions.  Every sum runs left to
// right from 0.0f with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into an FMA, in the order of the plain versions' loops (over d
// for |q|^2, |x|^2, q.x and |c|^2; over dsub in the table; over m in the
// scan).  Probes are taken by a block-wide argmin on (score, list index)
// among the lists not yet taken: the stable-sort order.  The result order
// is ascending (distance, flat position), position = probe rank * block +
// row: the lowest-flat-index tie rule of lax.top_k over the probe-major
// candidates.  Pad slots (id -1) are candidates at +inf; when fewer than k
// candidates exist the tail is id -1 at +inf.
//
// Bound on the H100 at the bench (b = 256 queries, d = 64, nlist = 256,
// block ~ 1016, nprobe = 2, k = 10): the flat scan reads at most the
// distinct probed posting blocks, block * (4d + 4) bytes each (67.6 MB if
// every list is probed, 0.020 ms at 3.35 TB/s), and does 2 b d (nlist +
// nprobe block) = 75 MFLOP (1.1 us at 67 TFLOP/s fp32): bound by bytes.
// PQ reads block * (m + 4) bytes per list (3.1 MB for all): launch-bound.
//
// Design, simple first: one block of 256 threads per query, two blocks a
// SM.
// - Rows reach shared memory in tiles of up to 256 rows by cp.async, every
//   copy of a tile in flight at once (coalesced 4-byte copies; rows padded
//   to d + 1 floats, so the 32 lanes reading 32 rows hit 32 banks); thread
//   t scores row t of a tile.  (Loads that wait on each other, one a loop
//   step, cost many times the tile's arithmetic.)
// - The coarse row: centroid tiles staged the same way, each thread
//   scoring its rows into a shared coarse row.  nprobe block-wide argmins
//   (warp shuffles, then one warp over the warps' winners) fill the probe
//   list; the owner thread of a list marks it taken, so nprobe == nlist
//   never takes a list twice.
// - Flat: each probed block streams through the tile buffer.  PQ: the
//   books are decoded once into shared memory, the table is built per
//   probe (m * ksub threads), and thread t scores rows t, t + 256, ...
//   from the codes in device memory (m bytes a row, coalesced).
// - Every thread keeps its k best (distance, position) sorted in registers:
//   a 16-entry list for k <= 16, else 32 (k <= 32), since each push
//   steps through the whole list.  The list is stepped through by index
//   sequences, not loops: written as unrolled loops it stayed in local
//   memory (a stack frame in nvcc's -Xptxas -v report, which the build
//   prints).  k rounds of block-wide argmin over the threads'
//   heads merge them; the winner pops its head, thread 0 writes the id
//   (looked up from the position) and the distance.
// Several queries per block, warp-level selection, wgmma for the coarse
// product and TMA for the posting blocks are later work.
//
// Every launcher returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape it refuses) so the caller sees a refused launch.  Nothing here
// synchronises or allocates.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;          // a thread's result list: k <= 32
constexpr int kShortK = 16;        // the list for k <= 16
constexpr int kNoPos = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr long kSmemLimit = 232448;   // 227 KB, Hopper's per-block opt-in

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src));
}

// Copy nrows rows of d floats from src into shared rows of d + 1 floats,
// every copy issued before any is waited for; returns after they landed
// (the caller's barrier then publishes them).
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int nrows, int d) {
  const int drow = kThreads / d;
  const int dcol = kThreads - drow * d;
  int row = threadIdx.x / d;
  int col = threadIdx.x - row * d;
  while (row < nrows) {
    cp_async4(dst + row * (d + 1) + col, src + static_cast<size_t>(row) * d +
                                             col);
    row += drow;
    col += dcol;
    if (col >= d) {
      col -= d;
      ++row;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x.x and q.x, each added left to right from 0.0f.
__device__ __forceinline__ void dots(const float* x, const float* q, int d,
                                     float& xx, float& qx) {
  xx = 0.0f;
  qx = 0.0f;
  for (int j = 0; j < d; ++j) {
    const float xj = x[j];
    xx = __fadd_rn(xx, __fmul_rn(xj, xj));
    qx = __fadd_rn(qx, __fmul_rn(q[j], xj));
  }
}

__device__ __forceinline__ bool before(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

__device__ __forceinline__ void warp_min(float& d, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_down_sync(kFull, d, off);
    const int op = __shfl_down_sync(kFull, p, off);
    if (before(od, op, d, p)) {
      d = od;
      p = op;
    }
  }
}

// Block-wide lexicographic minimum of (d, p); every thread returns with it.
__device__ __forceinline__ void block_min(float& d, int& p, float* red_d,
                                          int* red_p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_min(d, p);
  if (lane == 0) {
    red_d[warp] = d;
    red_p[warp] = p;
  }
  __syncthreads();
  if (warp == 0) {
    d = lane < kWarps ? red_d[lane] : CUDART_INF_F;
    p = lane < kWarps ? red_p[lane] : kNoPos;
    warp_min(d, p);
    if (lane == 0) {
      red_d[kWarps] = d;
      red_p[kWarps] = p;
    }
  }
  __syncthreads();
  d = red_d[kWarps];
  p = red_p[kWarps];
  __syncthreads();   // the slots are reused by the next call
}

// Coarse row |c|^2 - 2 q.c of every list (centroids staged through rows[],
// tile rows at a time), then the nprobe probes in ascending (score, index)
// order into probes[].  q_s must be written before the call.
__device__ __forceinline__ void select_probes(
    const float* q_s, const float* __restrict__ cents, int d, int nlist,
    int nprobe, int tile, float* rows, float* scores, int* taken,
    int* probes, float* red_d, int* red_p) {
  for (int c0 = 0; c0 < nlist; c0 += tile) {
    const int nrows = min(tile, nlist - c0);
    __syncthreads();   // q_s is written and the previous tile is scored
    stage_rows(rows, cents + static_cast<size_t>(c0) * d, nrows, d);
    __syncthreads();
    for (int row = threadIdx.x; row < nrows; row += kThreads) {
      float c2, qc;
      dots(rows + row * (d + 1), q_s, d, c2, qc);
      scores[c0 + row] = __fsub_rn(c2, __fmul_rn(2.0f, qc));
      taken[c0 + row] = 0;
    }
  }
  __syncthreads();
  // from here scores[l] and taken[l] are read and written by thread
  // l % kThreads only
  for (int r = 0; r < nprobe; ++r) {
    float best = CUDART_INF_F;
    int arg = kNoPos;
    for (int l = threadIdx.x; l < nlist; l += kThreads)
      if (!taken[l] && before(scores[l], l, best, arg)) {
        best = scores[l];
        arg = l;
      }
    block_min(best, arg, red_d, red_p);
    if (arg % kThreads == static_cast<int>(threadIdx.x)) taken[arg] = 1;
    if (threadIdx.x == 0) probes[r] = arg;
  }
  __syncthreads();
}

// A thread's K best (distance, position), ascending, in registers.  Each
// step over the list is a template instance with a constant index (an
// index sequence, not a loop), so the front end sees constant offsets and
// the list never needs an address in local memory.  (wd, wp) is the k-th
// entry, so a candidate that cannot enter costs one compare.
template <int K>
struct TopK {
  float d[K];
  int p[K];
  float wd;
  int wp;

  template <int I>
  __device__ __forceinline__ void clear() {
    d[I] = CUDART_INF_F;
    p[I] = kNoPos;
  }

  // slot I of the first k keeps the smaller of itself and the carried
  // candidate and carries the other on
  template <int I>
  __device__ __forceinline__ void step(int k, float& cd, int& cp) {
    if (I < k && before(cd, cp, d[I], p[I])) {
      const float td = d[I];
      const int tp = p[I];
      d[I] = cd;
      p[I] = cp;
      cd = td;
      cp = tp;
    }
  }

  template <int I>
  __device__ __forceinline__ void worst(int k) {
    if (I == k - 1) {
      wd = d[I];
      wp = p[I];
    }
  }

  template <int I>
  __device__ __forceinline__ void shift() {
    d[I] = d[I + 1];
    p[I] = p[I + 1];
  }

  template <int... I>
  __device__ __forceinline__ void clear_all(std::integer_sequence<int, I...>) {
    (this->template clear<I>(), ...);
  }

  template <int... I>
  __device__ __forceinline__ void insert(std::integer_sequence<int, I...>,
                                         int k, float cd, int cp) {
    (this->template step<I>(k, cd, cp), ...);
    (this->template worst<I>(k), ...);
  }

  template <int... I>
  __device__ __forceinline__ void shift_all(std::integer_sequence<int, I...>) {
    (this->template shift<I>(), ...);
  }

  __device__ __forceinline__ void init() {
    clear_all(std::make_integer_sequence<int, K>{});
    wd = CUDART_INF_F;
    wp = kNoPos;
  }

  // Insert (cd, cp); the k-th entry drops out.
  __device__ __forceinline__ void push(int k, float cd, int cp) {
    if (before(cd, cp, wd, wp))
      insert(std::make_integer_sequence<int, K>{}, k, cd, cp);
  }

  // Drop the head.
  __device__ __forceinline__ void pop() {
    shift_all(std::make_integer_sequence<int, K - 1>{});
    this->template clear<K - 1>();
  }
};

// Merge every thread's list into the block's k best and write them.
template <int K>
__device__ __forceinline__ void write_topk(TopK<K>& top, int k,
                                           const int* __restrict__ ids,
                                           const int* probes, int block,
                                           int* out_nn, float* out_d,
                                           float* red_d, int* red_p) {
  for (int i = 0; i < k; ++i) {
    float d = top.d[0];
    int p = top.p[0];
    block_min(d, p, red_d, red_p);
    // positions are unique, so one thread owns the winner
    if (p != kNoPos && top.p[0] == p) top.pop();
    if (threadIdx.x == 0) {
      out_nn[i] = p == kNoPos
                      ? -1
                      : __ldg(ids + static_cast<size_t>(probes[p / block]) *
                                        block + p % block);
      out_d[i] = d;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
flat_kernel(const float* __restrict__ q, const float* __restrict__ cents,
            const int* __restrict__ ids, const float* __restrict__ vecs,
            int* __restrict__ out_nn, float* __restrict__ out_d, int d,
            int nlist, int block, int nprobe, int k, int tile) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* scores = q_s + d;
  int* taken = reinterpret_cast<int*>(scores + nlist);
  int* probes = taken + nlist;
  float* red_d = reinterpret_cast<float*>(probes + nlist);
  int* red_p = reinterpret_cast<int*>(red_d + kWarps + 1);
  float* rows = reinterpret_cast<float*>(red_p + kWarps + 1);
  const size_t b = blockIdx.x;

  for (int j = threadIdx.x; j < d; j += kThreads) q_s[j] = q[b * d + j];
  select_probes(q_s, cents, d, nlist, nprobe, tile, rows, scores, taken,
                probes, red_d, red_p);

  float q2 = 0.0f;
  for (int j = 0; j < d; ++j) q2 = __fadd_rn(q2, __fmul_rn(q_s[j], q_s[j]));
  TopK<K> top;
  top.init();

  for (int r = 0; r < nprobe; ++r) {
    const size_t base = static_cast<size_t>(probes[r]) * block;
    for (int r0 = 0; r0 < block; r0 += tile) {
      const int nrows = min(tile, block - r0);
      __syncthreads();   // the previous tile is scored
      stage_rows(rows, vecs + (base + r0) * d, nrows, d);
      __syncthreads();
      for (int row = threadIdx.x; row < nrows; row += kThreads) {
        float dist = CUDART_INF_F;
        if (__ldg(ids + base + r0 + row) >= 0) {
          float x2, qx;
          dots(rows + row * (d + 1), q_s, d, x2, qx);
          dist = __fsub_rn(__fadd_rn(q2, x2), __fmul_rn(2.0f, qx));
        }
        top.push(k, dist, r * block + r0 + row);
      }
    }
  }
  write_topk(top, k, ids, probes, block, out_nn + b * k, out_d + b * k,
             red_d, red_p);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
pq_kernel(const float* __restrict__ q, const float* __restrict__ cents,
          const int* __restrict__ ids, const int8_t* __restrict__ codes,
          const int8_t* __restrict__ cb_q, const float* __restrict__ cb_s,
          int* __restrict__ out_nn, float* __restrict__ out_d, int d,
          int nlist, int block, int nprobe, int k, int m, int ksub,
          int tile) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* resid = q_s + d;
  float* scores = resid + d;
  int* taken = reinterpret_cast<int*>(scores + nlist);
  int* probes = taken + nlist;
  float* red_d = reinterpret_cast<float*>(probes + nlist);
  int* red_p = reinterpret_cast<int*>(red_d + kWarps + 1);
  float* books = reinterpret_cast<float*>(red_p + kWarps + 1);  // m*ksub*dsub
  float* lut = books + ksub * d;                                 // m*ksub
  float* rows = lut + m * ksub;          // centroid tiles of the coarse row
  const int dsub = d / m;
  const int entries = m * ksub;
  const size_t b = blockIdx.x;

  for (int j = threadIdx.x; j < d; j += kThreads) q_s[j] = q[b * d + j];
  for (int e = threadIdx.x; e < ksub * d; e += kThreads)
    books[e] = __fmul_rn(static_cast<float>(cb_q[e]), cb_s[e / dsub]);
  select_probes(q_s, cents, d, nlist, nprobe, tile, rows, scores, taken,
                probes, red_d, red_p);

  TopK<K> top;
  top.init();

  for (int r = 0; r < nprobe; ++r) {
    const int lst = probes[r];
    const size_t base = static_cast<size_t>(lst) * block;
    __syncthreads();   // the previous table is consumed
    const float* cent = cents + static_cast<size_t>(lst) * d;
    for (int j = threadIdx.x; j < d; j += kThreads)
      resid[j] = __fsub_rn(q_s[j], __ldg(cent + j));
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += kThreads) {
      const float* rs = resid + (e / ksub) * dsub;
      const float* bk = books + e * dsub;
      float acc = 0.0f;
      for (int t = 0; t < dsub; ++t) {
        const float diff = __fsub_rn(rs[t], bk[t]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      lut[e] = acc;
    }
    __syncthreads();
    for (int row = threadIdx.x; row < block; row += kThreads) {
      float dist = CUDART_INF_F;
      if (__ldg(ids + base + row) >= 0) {
        const int8_t* cr = codes + (base + row) * m;
        float acc = 0.0f;
        for (int s = 0; s < m; ++s)
          acc = __fadd_rn(acc, lut[s * ksub + static_cast<int>(__ldg(cr + s))]);
        dist = acc;
      }
      top.push(k, dist, r * block + row);
    }
  }
  write_topk(top, k, ids, probes, block, out_nn + b * k, out_d + b * k,
             red_d, red_p);
}

int check_shape(int b, int d, int nlist, int block, int nprobe, int k) {
  if (b < 0 || d < 1 || nlist < 1 || block < 1 || nprobe < 1 ||
      nprobe > nlist || k < 1 || k > kMaxK ||
      static_cast<long>(nlist) * block > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// neighbors nn (b, k) i32 and distances dist (b, k) f32 of a flat search.
// q (b, d), cents (nlist, d), vecs (nlist * block, d) f32; ids (nlist,
// block) i32.  tile (rows staged at once, 1..256) and smem (the bytes of
// the layout the kernel carves) come from ops/retrieve.py::kernel_plan,
// the one place that sizes the layout; the launcher checks only the cap.
int retrieve_flat_launch(const void* q, const void* cents, const void* ids,
                         const void* vecs, void* nn, void* dist, int b, int d,
                         int nlist, int block, int nprobe, int k, int tile,
                         long smem, void* stream) {
  int rc = check_shape(b, d, nlist, block, nprobe, k);
  if (rc) return rc;
  if (tile < 1 || tile > kThreads || smem < 1 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = k <= kShortK ? flat_kernel<kShortK> : flat_kernel<kMaxK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cents),
      static_cast<const int*>(ids), static_cast<const float*>(vecs),
      static_cast<int*>(nn), static_cast<float*>(dist), d, nlist, block,
      nprobe, k, tile);
  return static_cast<int>(cudaGetLastError());
}

// The same for IVF-PQ: codes (nlist * block, m) i8 with values in
// [0, ksub), cb_q (m, ksub, d / m) i8, cb_s (m, ksub) f32.  tile: the
// centroid rows staged at once; tile and smem as above.
int retrieve_pq_launch(const void* q, const void* cents, const void* ids,
                       const void* codes, const void* cb_q, const void* cb_s,
                       void* nn, void* dist, int b, int d, int nlist,
                       int block, int nprobe, int k, int m, int ksub,
                       int tile, long smem, void* stream) {
  int rc = check_shape(b, d, nlist, block, nprobe, k);
  if (rc) return rc;
  if (m < 1 || d % m || ksub < 2 || ksub > 127 || tile < 1 ||
      tile > kThreads || smem < 1 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = k <= kShortK ? pq_kernel<kShortK> : pq_kernel<kMaxK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cents),
      static_cast<const int*>(ids), static_cast<const int8_t*>(codes),
      static_cast<const int8_t*>(cb_q), static_cast<const float*>(cb_s),
      static_cast<int*>(nn), static_cast<float*>(dist), d, nlist, block,
      nprobe, k, m, ksub, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
