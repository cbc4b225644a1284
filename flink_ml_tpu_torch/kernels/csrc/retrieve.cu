// Hand-written Hopper (sm_90a) kernels for IVF search
// (flink_ml_tpu_torch/ops/retrieve.py): coarse probe selection, the scan of
// the probed posting lists and the top-k, one call per search.
//
// Replaces flink_ml_tpu/ops/retrieve_pallas.py:
// - flat_probe_kernel, flat_scan_kernel:
//   retrieve_flat_fused (_flat_kernel, _merge_topk, _select_first_min).
//   Squared L2 (|q|^2 + |x|^2) - 2 q.x over f32 rows.
// - pq_kernel: retrieve_pq_fused (_pq_kernel).  Asymmetric distances: the
//   books decoded (cb_q * cb_s), per probe the residual r = q - c[probe]
//   and its table lut[s][c] = sum_t (r[s][t] - book[s][c][t])^2, then
//   sum_s lut[s][code[s]] over the int8 codes of the probed block.
//
// Bit for bit with the plain PyTorch versions.  Every sum runs left to
// right from 0.0f with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into an FMA, in the order of the plain versions' loops (over d
// for |q|^2, |x|^2, q.x and |c|^2; over dsub in the table; over m in the
// scan).  Probes are taken by an argmin on (score, list index) among the
// lists not yet taken: the stable-sort order.  The result order
// is ascending (distance, flat position), position = probe rank * block +
// row: the lowest-flat-index tie rule of lax.top_k over the probe-major
// candidates.  Pad slots (id -1) are candidates at +inf; when fewer than k
// candidates exist the tail is id -1 at +inf.
//
// Bound on the H100 at the bench (b = 256 queries, d = 64, nlist = 256,
// block ~ 1016, nprobe = 2, k = 10): the flat scan reads at most the
// distinct probed posting blocks, block * (4d + 4) bytes each (49 MB for
// the 185 lists nprobe 2 probes, 0.0146 ms at 3.35 TB/s; 67.6 MB if every
// list is probed), and does 2 b d (nlist + nprobe block) = 75 MFLOP (1.1
// us at 67 TFLOP/s fp32): bound by bytes.  PQ reads block * (m + 4) bytes
// per list (3.1 MB for all): launch-bound.
//
// Flat: list-major (the section "flat search, list-major" below).  The
// scan reads each probed list once for each span of the queries that
// probe it (once in all at the bench's b = 256 up to nprobe 16), not once
// per query (the one-block-a-query design before read 135 MB at nprobe 2, most of it again from
// L2): two launches, the probes (which write each list's membership) and
// the scan (whose last block per query merges that query's partial
// results).
//
// PQ, simple first: one block of 256 threads per query, two blocks a SM.
// - The coarse row: centroid tiles staged by cp.async (coalesced 4-byte
//   copies; rows padded to d + 1 floats, so the 32 lanes reading 32 rows
//   hit 32 banks), each thread scoring its rows into a shared coarse row.
//   nprobe block-wide argmins (warp shuffles, then one warp over the
//   warps' winners) fill the probe list; the owner thread of a list marks
//   it taken, so nprobe == nlist never takes a list twice.
// - The books are decoded once into shared memory, the table is built per
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

// ---- flat search, list-major: two launches -----------------------------
// 1. flat_probe_kernel: up to kWarps queries a block (as many as keep
//    the SMs busy) share each staged tile of centroids (16-byte cp.async);
//    |c|^2 once a row a tile, every thread scores (query, row) pairs, then
//    warp w takes query w's nprobe probes by warp argmins on (score,
//    index) over the lists not taken: the order select_probes gives,
//    probes (b, nprobe).  The block then writes its queries' column of
//    the membership table member (nlist, b): rank + 1 where the query
//    probes the list at that rank, else 0 (nq consecutive words a list).
// 2. flat_scan_kernel: one block a (list, span of queries, chunk of up
//    to kChunk rows of the list; fewer for wide rows).  The spans split
//    the b queries into `groups` equal parts, as many as give each block
//    about kQ * kRounds of the list's queries on average: sized from b,
//    nprobe and nlist alone (no host sync).  The block reads its span's
//    row of member (coalesced), 256 queries at a time, and compacts the
//    ones that probe the list (warp ballots, ascending query); a block
//    with none exits without touching the list.  Else it loads the chunk
//    once (16-byte cp.async), |x|^2 once a row, and scores its queries in
//    rounds of kQ: warp w scores one query over the chunk, kChunk / 32
//    rows a lane (independent chains), and keeps the k best (distance,
//    position) of its (query, rank, chunk) as 64-bit keys: each lane sorts
//    its own in registers, k rounds of butterfly minima pick the warp's.
//    Several blocks an SM overlap one chunk's loads with another's
//    arithmetic, and the launch is a programmatic dependent one: its
//    blocks start while the probe launch runs and wait for its results
//    (griddepcontrol.wait), which hides the second launch's latency
//    (0.001 ms at the bench, scripts/retrieve_phase_times.py).  Two rounds
//    a block on average read the list fewer times than one and keep more
//    blocks in flight than four (the same script times 1 and 4).  The
//    block whose partial of a query lands last (a device
//    counter the probe launch zeroes) merges the query's nprobe * chunks *
//    k partials the same way and writes its ids and distances: every
//    partial is in by then, so the result does not depend on which block
//    arrives last.
// So each probed list is read once for each span with queries that probe
// it (once in all at the bench's b = 256 up to nprobe 16: one span), and
// no part of grouping the queries by list runs in one block: each scan
// block reads its own span's membership.
// A (query, row) distance is the same expression in the same order
// whichever block computes it, and the merge by (distance, position) does
// not depend on the order in which candidates arrive: the result equals
// the plain version bit for bit.

constexpr int kQ = kWarps;        // queries a scan round: one a warp
constexpr int kRounds = 2;        // rounds a scan block on average
constexpr int kChunk = 256;       // most rows a scan block: eight a lane
constexpr int kProbeRows = 256;   // most centroid rows a probe tile

// Copy rows [0, nrows) of d floats at src into shared rows of rs floats
// (16-byte copies where vec), no wait.
template <bool kVec>
__device__ __forceinline__ void stage_rows_async(float* dst,
                                                 const float* __restrict__ src,
                                                 int nrows, int d, int rs) {
  if (kVec) {
    const int d4 = d / 4;
    for (int e = threadIdx.x; e < nrows * d4; e += kThreads) {
      const int row = e / d4;
      const int c = (e - row * d4) * 4;
      const unsigned addr = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + row * rs + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
                   "l"(src + static_cast<size_t>(row) * d + c));
    }
  } else {
    for (int e = threadIdx.x; e < nrows * d; e += kThreads) {
      const int row = e / d;
      cp_async4(dst + row * rs + (e - row * d), src + e);
    }
  }
}

// sum_j a[j] * b[j] over d, left to right from 0.0f
template <bool kVec>
__device__ __forceinline__ float dot_seq(const float* a, const float* b,
                                         int d) {
  float s = 0.0f;
  if (kVec) {
    for (int j = 0; j < d; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(a + j);
      const float4 v = *reinterpret_cast<const float4*>(b + j);
      s = __fadd_rn(s, __fmul_rn(u.x, v.x));
      s = __fadd_rn(s, __fmul_rn(u.y, v.y));
      s = __fadd_rn(s, __fmul_rn(u.z, v.z));
      s = __fadd_rn(s, __fmul_rn(u.w, v.w));
    }
  } else {
    for (int j = 0; j < d; ++j) s = __fadd_rn(s, __fmul_rn(a[j], b[j]));
  }
  return s;
}

// q.x of N rows at once (N independent chains), each left to right
template <int N, bool kVec>
__device__ __forceinline__ void dots_n(const float* qv, const float* rows,
                                       int rs, int first, int step, int d,
                                       float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  if (kVec) {
    for (int j = 0; j < d; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(qv + j);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            rows + (first + i * step) * rs + j);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(u.x, x.x));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(u.y, x.y));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(u.z, x.z));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(u.w, x.w));
      }
    }
  } else {
    for (int j = 0; j < d; ++j) {
      const float u = qv[j];
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(u, rows[(first + i * step) * rs
                                                     + j]));
    }
  }
}

// (distance, position) as one 64-bit key, ascending in the order of
// before(): the distance's bits made monotone (negative ones flipped, the
// sign bit set on the rest), then the position.  Distances here are never
// -0.0 (a rounded difference of equal values is +0.0), the one value the
// two orders would part on.  kNoKey, (+inf, kNoPos), comes after every
// candidate, pads at +inf included.
using Key = unsigned long long;
constexpr Key kNoKey = 0xff8000007fffffffull;

__device__ __forceinline__ Key make_key(float d, int p) {
  unsigned u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(u) << 32) | static_cast<unsigned>(p);
}

__device__ __forceinline__ float key_dist(Key key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_pos(Key key) {
  return static_cast<int>(key & 0xffffffffu);
}

// The warp's k smallest of its lanes' N keys each: each lane sorts its
// keys in registers, then k rounds of a butterfly minimum over the lanes'
// heads, the owner of each winner popping it (keys are unique, kNoKey
// aside).  Lane i < k returns the i-th smallest; the others kNoKey.
template <int N>
__device__ __forceinline__ Key warp_select(Key (&key)[N], int k) {
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int j = r & 1; j + 1 < N; j += 2) {
      const Key a = key[j];
      const Key b = key[j + 1];
      key[j] = a < b ? a : b;
      key[j + 1] = a < b ? b : a;
    }
  const int lane = threadIdx.x & 31;
  Key mine = kNoKey;
  for (int i = 0; i < k; ++i) {
    Key m = key[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Key o = __shfl_xor_sync(kFull, m, off);
      m = o < m ? o : m;
    }
    if (key[0] == m) {
#pragma unroll
      for (int j = 0; j + 1 < N; ++j) key[j] = key[j + 1];
      key[N - 1] = kNoKey;
    }
    if (lane == i) mine = m;
  }
  return mine;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
flat_probe_kernel(const float* __restrict__ q,
                  const float* __restrict__ cents, int* __restrict__ probes,
                  int* __restrict__ member, int* __restrict__ arrived, int b,
                  int d, int nlist, int nprobe, int nq, int prow) {
  extern __shared__ float smem[];
  const int rs = kVec ? d + 4 : d + 1;
  float* qs = smem;                                   // nq x d
  float* c2 = qs + nq * d;                            // prow
  float* tile = c2 + prow;                            // prow x rs
  float* scores = tile + prow * rs;                   // nq x nlist
  int* taken = reinterpret_cast<int*>(scores + static_cast<size_t>(nq) *
                                                   nlist);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * nq;
  const int nb = min(nq, b - q0);
  // the scan launch may start (up to its griddepcontrol.wait) once every
  // probe block has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  for (int e = threadIdx.x; e < nb * d; e += kThreads)
    qs[e] = q[static_cast<size_t>(q0) * d + e];
  float* sc = scores + static_cast<size_t>(warp) * nlist;
  int* tk = taken + static_cast<size_t>(warp) * nlist;
  for (int c0 = 0; c0 < nlist; c0 += prow) {
    const int nrows = min(prow, nlist - c0);
    __syncthreads();   // the previous tile is scored
    stage_rows_async<kVec>(tile, cents + static_cast<size_t>(c0) * d, nrows,
                           d, rs);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int row = threadIdx.x; row < nrows; row += kThreads)
      c2[row] = dot_seq<kVec>(tile + row * rs, tile + row * rs, d);
    __syncthreads();
    // every thread scores (query, row) pairs: one chain each
    for (int e = threadIdx.x; e < nb * nrows; e += kThreads) {
      const int w = e / nrows;
      const int row = e - w * nrows;
      const float qc = dot_seq<kVec>(qs + w * d, tile + row * rs, d);
      const size_t at = static_cast<size_t>(w) * nlist + c0 + row;
      scores[at] = __fsub_rn(c2[row], __fmul_rn(2.0f, qc));
      taken[at] = 0;
    }
  }
  __syncthreads();
  if (warp < nb) {
    if (lane == 0) arrived[q0 + warp] = 0;   // the scan's merge counters
    for (int r = 0; r < nprobe; ++r) {
      float best = CUDART_INF_F;
      int arg = kNoPos;
      for (int l = lane; l < nlist; l += 32)
        if (!tk[l] && before(sc[l], l, best, arg)) {
          best = sc[l];
          arg = l;
        }
      warp_min(best, arg);
      arg = __shfl_sync(kFull, arg, 0);
      if (lane == 0) {
        if (arg != kNoPos) tk[arg] = r + 1;
        probes[static_cast<size_t>(q0 + warp) * nprobe + r] = arg;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // the queries' columns of member: the rank + 1 the taken flags hold
  for (int e = threadIdx.x; e < nb * nlist; e += kThreads) {
    const int l = e / nb;
    const int j = e - l * nb;
    member[static_cast<size_t>(l) * b + q0 + j] =
        taken[static_cast<size_t>(j) * nlist + l];
  }
}

// Merge query qi's n = nprobe * chunks * k partial keys with one warp,
// 32 * kPerLane at a time beside the k it holds, and write its ids and
// distances.  The partials were written by other blocks: read past L1
// (__ldcg).
constexpr int kPerLane = kChunk / 32;

__device__ __forceinline__ void merge_query(
    int qi, const Key* part, int n, const int* probes,
    const int* __restrict__ ids, int* __restrict__ out_nn,
    float* __restrict__ out_d, int nprobe, int block, int k) {
  const int lane = threadIdx.x & 31;
  const size_t at = static_cast<size_t>(qi) * n;
  Key mine = kNoKey;
  for (int e0 = 0; e0 < n; e0 += 32 * kPerLane) {
    Key key[kPerLane + 1];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = e0 + lane + 32 * j;
      key[j] = e < n ? __ldcg(part + at + e) : kNoKey;
    }
    key[kPerLane] = mine;
    mine = warp_select(key, k);
  }
  if (lane < k) {
    const int p = key_pos(mine);
    const size_t out = static_cast<size_t>(qi) * k + lane;
    out_nn[out] = p == kNoPos
                      ? -1
                      : __ldg(ids + static_cast<size_t>(__ldcg(
                                        probes + static_cast<size_t>(qi) *
                                                     nprobe + p / block)) *
                                        block + p % block);
    out_d[out] = key_dist(mine);
  }
}

// Warp w's (query, rank) `pair` against the staged chunk (rows r0 ..
// r0 + nrows of the pair's list): its k best as a partial, and the merge
// where it is the query's last.
template <bool kVec>
__device__ __forceinline__ void score_pair(
    int pair, const float* qv, const float* rows, const float* x2,
    const int* rid, int rs, int r0, int nrows, int chunk, int c, int chunks,
    const int* probes, const int* __restrict__ ids, Key* part,
    int* arrived, int* __restrict__ out_nn, float* __restrict__ out_d,
    int d, int block, int nprobe, int k) {
  const int lane = threadIdx.x & 31;
  const float q2 = dot_seq<kVec>(qv, qv, d);
  const int base = (pair % nprobe) * block + r0;
  // rows lane + 32 i: kPerLane candidates a lane, pads at +inf.  Full
  // kChunk-row chunks (a list's last chunk too) score all kPerLane rows
  // unrolled, rows past the chunk's end reading stale shared memory that
  // is never used; smaller chunks (wide rows) guard each row.
  Key key[kPerLane];
  if (chunk == kChunk) {
    float acc[kPerLane];
    dots_n<kPerLane, kVec>(qv, rows, rs, lane, 32, d, acc);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int row = lane + 32 * i;
      const float dist =
          rid[row] >= 0
              ? __fsub_rn(__fadd_rn(q2, x2[row]), __fmul_rn(2.0f, acc[i]))
              : CUDART_INF_F;
      key[i] = row < nrows ? make_key(dist, base + row) : kNoKey;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int row = lane + 32 * i;
      key[i] = kNoKey;
      if (row < nrows) {
        float dist = CUDART_INF_F;
        if (rid[row] >= 0) {
          const float qx = dot_seq<kVec>(qv, rows + row * rs, d);
          dist = __fsub_rn(__fadd_rn(q2, x2[row]), __fmul_rn(2.0f, qx));
        }
        key[i] = make_key(dist, base + row);
      }
    }
  }
  const Key mine = warp_select(key, k);
  const size_t at = (static_cast<size_t>(pair) * chunks + c) * k;
  if (lane < k) part[at + lane] = mine;
  // the last of a query's nprobe * chunks partials to land merges it
  const int qi = pair / nprobe;
  __threadfence();   // every lane's partial is out before the count
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(arrived + qi, 1) == nprobe * chunks - 1;
    if (last) __threadfence();
  }
  if (__shfl_sync(kFull, last, 0))
    merge_query(qi, part, nprobe * chunks * k, probes, ids, out_nn, out_d,
                nprobe, block, k);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
flat_scan_kernel(const float* __restrict__ q, const int* __restrict__ ids,
                 const float* __restrict__ vecs,
                 const int* __restrict__ member, const int* probes,
                 Key* part, int* arrived, int* __restrict__ out_nn,
                 float* __restrict__ out_d, int b, int d, int block,
                 int nprobe, int k, int chunk, int chunks, int groups,
                 int span) {
  const int item = blockIdx.x / chunks;
  const int c = blockIdx.x - item * chunks;
  const int l = item / groups;
  const int q_lo = (item - l * groups) * span;
  const int q_hi = min(b, q_lo + span);
  const int r0 = c * chunk;
  const int nrows = min(chunk, block - r0);
  const int rs = kVec ? d + 4 : d + 1;
  extern __shared__ float smem[];
  float* qs = smem;                                  // kQ x d
  float* x2 = qs + kQ * d;                           // chunk
  int* rid = reinterpret_cast<int*>(x2 + chunk);     // chunk
  int* sel = rid + chunk;                            // kThreads
  float* rows = reinterpret_cast<float*>(sel + kThreads);   // chunk x rs
  __shared__ int warp_n[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t slot0 = static_cast<size_t>(l) * block + r0;
  const int* mrow = member + static_cast<size_t>(l) * b;
  bool staged = false;
  // the launch starts during the probe launch: wait for its results
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  for (int w0 = q_lo; w0 < q_hi; w0 += kThreads) {
    // the window's queries that probe the list, ascending: (query, rank)
    // pairs query * nprobe + rank
    const int qi = w0 + threadIdx.x;
    const int rank = qi < q_hi ? __ldg(mrow + qi) : 0;
    const unsigned m = __ballot_sync(kFull, rank > 0);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int at = 0, n = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = warp_n[w];
      at += w < warp ? cnt : 0;
      n += cnt;
    }
    if (rank > 0)
      sel[at + __popc(m & ((1u << lane) - 1))] = qi * nprobe + rank - 1;
    __syncthreads();   // sel is written and warp_n read
    if (n == 0) continue;
    if (!staged) {
      // the chunk's copies go out first; the first round's queries
      // load meanwhile
      stage_rows_async<kVec>(rows, vecs + slot0 * d, nrows, d, rs);
      for (int row = threadIdx.x; row < nrows; row += kThreads)
        cp_async4(reinterpret_cast<float*>(rid + row),
                  reinterpret_cast<const float*>(ids + slot0 + row));
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int j0 = 0; j0 < n; j0 += kQ) {
      const int nq = min(kQ, n - j0);
      for (int e = threadIdx.x; e < nq * d; e += kThreads) {
        const int w = e / d;
        qs[e] = __ldg(q + static_cast<size_t>(sel[j0 + w] / nprobe) * d +
                      (e - w * d));
      }
      if (!staged) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        for (int row = threadIdx.x; row < nrows; row += kThreads)
          x2[row] = dot_seq<kVec>(rows + row * rs, rows + row * rs, d);
        staged = true;
      }
      __syncthreads();
      if (warp < nq)
        score_pair<kVec>(sel[j0 + warp], qs + warp * d, rows, x2, rid, rs,
                         r0, nrows, chunk, c, chunks, probes, ids, part,
                         arrived, out_nn, out_d, d, block, nprobe, k);
      __syncthreads();   // qs and sel are reused
    }
  }
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

// 32-bit words of scratch the list-major flat search takes: the partial
// keys (8-byte aligned, first), probes (b, nprobe), member (nlist, b) and
// the merge counters (b).
long flat_scratch_words(int b, int nlist, int block, int nprobe, int k,
                        int chunk) {
  if (chunk < 1) return 0;
  const long chunks = (block + chunk - 1) / chunk;
  const long pairs = static_cast<long>(b) * nprobe;
  return 2 * pairs * chunks * k + pairs + static_cast<long>(nlist) * b + b;
}

// neighbors nn (b, k) i32 and distances dist (b, k) f32 of a flat search:
// flat_probe_kernel, then flat_scan_kernel; no memset, no host sync.
// q (b, d), cents (nlist, d), vecs (nlist * block, d) f32; ids (nlist,
// block) i32.  scratch: flat_scratch_words(b, nlist, block, nprobe, k,
// chunk) words of device memory, 8-byte aligned.  The probe
// launch's queries a block, centroid rows a tile and bytes, the scan's
// rows a block and bytes come from ops/retrieve.py::flat_plan, the one
// place that sizes them; the launcher checks only the caps, and splits
// the queries into the scan's spans.
int retrieve_flat_launch(const void* q, const void* cents, const void* ids,
                         const void* vecs, void* nn, void* dist,
                         void* scratch, int b, int d, int nlist, int block,
                         int nprobe, int k, int probe_queries,
                         int probe_rows, long probe_smem, int chunk,
                         long scan_smem, void* stream) {
  int rc = check_shape(b, d, nlist, block, nprobe, k);
  if (rc) return rc;
  if (chunk < 1 || chunk > kChunk || chunk % 4 || probe_rows < 1 ||
      probe_rows > kProbeRows || probe_rows % 4 || probe_queries < 1 ||
      probe_queries > kWarps || probe_smem < 1 ||
      probe_smem > kSmemLimit || scan_smem < 1 || scan_smem > kSmemLimit ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long chunks = (block + chunk - 1) / chunk;
  // spans of the queries: about kQ * kRounds of a list's queries a span
  const long per_list = (static_cast<long>(b) * nprobe + nlist - 1) / nlist;
  long groups = (per_list + kQ * kRounds - 1) / (kQ * kRounds);
  if (groups > b) groups = b;
  if (groups < 1) groups = 1;
  const long span = (b + groups - 1) / groups;
  groups = (b + span - 1) / span;
  if (static_cast<long>(b) * nprobe * chunks * k > 0x7fffffffL ||
      static_cast<long>(nlist) * b > 0x7fffffffL ||
      nlist * groups * chunks > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t npairs = static_cast<size_t>(b) * nprobe;
  Key* part = static_cast<Key*>(scratch);   // first: 8-byte aligned
  int* probes = reinterpret_cast<int*>(part + npairs * chunks * k);
  int* member = probes + npairs;
  int* arrived = member + static_cast<size_t>(nlist) * b;
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(vecs) |
                    reinterpret_cast<uintptr_t>(cents)) % 16 == 0;
  auto probe = vec ? flat_probe_kernel<true> : flat_probe_kernel<false>;
  auto scan = vec ? flat_scan_kernel<true> : flat_scan_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(probe_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  probe<<<(b + probe_queries - 1) / probe_queries, kThreads, probe_smem,
          s>>>(static_cast<const float*>(q), static_cast<const float*>(cents),
               probes, member, arrived, b, d, nlist, nprobe, probe_queries,
               probe_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a programmatic dependent launch: its blocks start during the probe
  // launch and wait for it at griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nlist * groups * chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(scan_smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, scan, static_cast<const float*>(q), static_cast<const int*>(ids),
      static_cast<const float*>(vecs), static_cast<const int*>(member),
      static_cast<const int*>(probes), part, arrived, static_cast<int*>(nn),
      static_cast<float*>(dist), b, d, block, nprobe, k, chunk,
      static_cast<int>(chunks), static_cast<int>(groups),
      static_cast<int>(span));
  if (err != cudaSuccess) return static_cast<int>(err);
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
