// Hand-written Hopper (sm_90a) kernels for IVF search
// (flink_ml_tpu_torch/ops/retrieve.py): coarse probe selection, the scan of
// the probed posting lists and the top-k, two launches a search.
//
// Replaces flink_ml_tpu/ops/retrieve_pallas.py:
// - flat_probe_kernel + scan_kernel<FlatRows>: retrieve_flat_fused
//   (_flat_kernel, _merge_topk, _select_first_min).  Squared L2
//   (|q|^2 + |x|^2) - 2 q.x over f32 rows.
// - flat_probe_kernel + scan_kernel<PqCodes>: retrieve_pq_fused
//   (_pq_kernel).  Asymmetric distances: the books decoded (cb_q * cb_s),
//   per (query, probe) the residual r = q - c[probe] and its table
//   lut[s][c] = sum_t (r[s][t] - book[s][c][t])^2, then
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
// Bounds on the H100 at the bench (b = 256 queries, d = 64, nlist = 256,
// block ~ 1016, nprobe = 2, k = 10): the flat scan reads at most the
// distinct probed posting blocks, block * (4d + 4) bytes each (49 MB for
// the 185 lists nprobe 2 probes, 0.0146 ms at 3.35 TB/s; 67.6 MB if every
// list is probed), and does 2 b d (nlist + nprobe block) = 75 MFLOP (1.1
// us at 67 TFLOP/s fp32): bound by bytes.  PQ (m = 8, ksub = 16) reads
// block * (m + 4) bytes a list, 3.1 MB for all 256 lists (0.0009 ms), and
// its tables and lookups are ~3 MFLOP at nprobe 2: far below the latency
// of one launch, so PQ is bound by launch and latency: how long the
// dependent chain of one query's work is, and how many such chains run
// at once.
//
// Both searches are list-major (the section "list-major search" below):
// the probe launch, shared, writes each list's membership; the scan reads
// each probed list once for each span of the queries that probe it, and
// the block that lands a query's last partial merges that query.  One
// scan kernel, a template over the scorer (flat rows or PQ codes), holds
// the compaction of a list's queries, the staging of ids, the selection,
// the partial write and the merge once.  For PQ this replaces one long
// chain a query (one block a query re-staging every centroid for its
// coarse row, nprobe block-wide argmins, per probe a table and a scan
// fenced by barriers, then k more block-wide argmins: 0.0254 ms at nprobe
// 1 and +4.4 us a probe) with chains that run side by side: the probes of
// all queries in one launch that scores several queries per staged
// centroid tile, then one warp a (query, probe), which builds its own
// table in shared memory and scores the whole list 8 rows a lane at a
// time, later rows costing one compare against the k-th best so far.
// What is left is latency: the selections and the merge (the variants of
// scripts/retrieve_phase_times.py switch them off in turn).

// Every launcher returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape it refuses) so the caller sees a refused launch.  Nothing here
// synchronises or allocates.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;          // the most results a query: k <= 32
constexpr int kNoPos = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr long kSmemLimit = 232448;   // 227 KB, Hopper's per-block opt-in

// One 4-byte asynchronous copy from device to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src));
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

// ---- list-major search: two launches ------------------------------------
// 1. flat_probe_kernel (both searches): up to kWarps queries a block (as
//    many as keep the SMs busy) share each staged tile of centroids
//    (16-byte cp.async); |c|^2 once a row a tile, every thread scores
//    (query, row) pairs, then warp w takes query w's nprobe probes by warp
//    argmins on (score, index) over the lists not taken: probes (b,
//    nprobe).  The block then writes its queries' column of the
//    membership table member (nlist, b): rank + 1 where the query probes
//    the list at that rank, else 0 (nq consecutive words a list).  It
//    zeroes its queries' merge counters.
// 2. scan_kernel<Scorer>: one block a (list, span of queries, chunk of
//    rows of the list: up to kChunk flat rows, fewer for wide rows; up to
//    kPqChunk PQ rows, a whole list at the bench).  The spans split the b
//    queries into `groups` equal parts, as many as give each block about
//    `round` * kRounds of the list's queries on average (`round`: the
//    queries a scoring round, one a warp), and for PQ more, up to kFill
//    blocks in all, where a busy list would otherwise take several rounds
//    in one block: sized from b, nprobe and nlist alone (no host sync).
//    The block reads its span's row of member (coalesced), 256 queries at
//    a time, and compacts the ones that probe the list (warp ballots,
//    ascending query); a block with none exits without scoring.  Else it
//    loads the chunk once (cp.async; PQ, whose chunk is small, before the
//    probes are in) and scores its queries in rounds: warp w takes one
//    (query, rank) over the chunk in passes of kChunk rows, kPerLane rows
//    a lane (independent chains), and keeps the k best (distance,
//    position) as 64-bit keys: the first pass by warp_select (each lane
//    sorts its keys in registers, k rounds of warp minima), later passes
//    by warp_merge against the k-th best so far.  The scorers:
//    - FlatRows: the rows (16-byte copies where d % 4 == 0), |x|^2 once a
//      row, a round's queries staged by the block, q.x for 8 rows a lane.
//    - PqCodes: the books decoded into shared memory before the launch
//      waits for the probes (they do not depend on them), the chunk's
//      codes (4-byte copies where m % 4 == 0), a round's residuals
//      q - c[list] staged by the block; each warp builds its query's m x
//      ksub table (4 entries at a time, books stored entry-minor so a
//      warp's 32 entries read 32 banks), then adds m table entries for
//      each of its 8 rows a lane.
//    Several blocks an SM overlap one chunk's loads with another's
//    arithmetic, and the launch is a programmatic dependent one: its
//    blocks start while the probe launch runs and wait for its results
//    (griddepcontrol.wait), which hides the second launch's latency.
//    The block whose partial of a query lands last (a device counter the
//    probe launch zeroes) merges the query's nprobe * chunks partials and
//    writes its ids and distances: every partial is in by then, so the
//    result does not depend on which block arrives last.  A query with
//    one partial (nprobe 1, one chunk a list) is written at once.
// So each probed list is read once for each span with queries that probe
// it, and no part of grouping the queries by list runs in one block: each
// scan block reads its own span's membership.  A (query, row) distance is
// the same expression in the same order whichever block computes it, and
// the merge by (distance, position) does not depend on the order in which
// candidates arrive: the result equals the plain version bit for bit.

constexpr int kQ = kWarps;        // most queries a scan round: one a warp
constexpr long kSkew = 5;         // see launch_search
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
// keys in registers, then k rounds of a warp minimum over the lanes'
// heads (two 32-bit warp reductions: the distance bits, then the position
// among the heads with those bits), the owner of each winner popping it
// (keys are unique, kNoKey aside); the rounds stop where only kNoKey is
// left.  Lane i < k returns the i-th smallest; the others kNoKey.
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
    const unsigned hi = static_cast<unsigned>(key[0] >> 32);
    const unsigned top = __reduce_min_sync(kFull, hi);
    const unsigned low = __reduce_min_sync(
        kFull, hi == top ? static_cast<unsigned>(key[0]) : 0xffffffffu);
    const Key m = (static_cast<Key>(top) << 32) | low;
    if (m == kNoKey) break;
    if (key[0] == m) {
#pragma unroll
      for (int j = 0; j + 1 < N; ++j) key[j] = key[j + 1];
      key[N - 1] = kNoKey;
    }
    if (lane == i) mine = m;
  }
  return mine;
}

// mine (the warp's k best so far: lane i < k the i-th, the other lanes
// kNoKey) merged with the lanes' N keys each.  After a first warp_select
// of a query's rows most of its later rows fall behind the k-th best:
// where at most kInsertMost keys come before it, each goes in at its rank,
// one at a time (warp ballots), the k-th dropping out; else warp_select
// runs over the keys and mine.  Keys are unique, so either way the result
// is warp_select's over the same keys.
constexpr int kInsertMost = 16;

template <int N>
__device__ __forceinline__ Key warp_merge(const Key (&key)[N], Key mine,
                                          int k) {
  const int lane = threadIdx.x & 31;
  Key kth = __shfl_sync(kFull, mine, k - 1);
  int before_kth = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    before_kth += __popc(__ballot_sync(kFull, key[i] < kth));
  if (before_kth > kInsertMost) {
    Key all[N + 1];
#pragma unroll
    for (int i = 0; i < N; ++i) all[i] = key[i];
    all[N] = mine;
    return warp_select(all, k);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    unsigned has = __ballot_sync(kFull, key[i] < kth);
    while (has) {
      const Key x = __shfl_sync(kFull, key[i], __ffs(has) - 1);
      has &= has - 1;
      if (x < kth) {
        const int at = __popc(__ballot_sync(kFull, mine < x));
        const Key up = __shfl_up_sync(kFull, mine, 1);
        mine = lane >= k ? kNoKey : lane > at ? up : lane == at ? x : mine;
        kth = __shfl_sync(kFull, mine, k - 1);
      }
    }
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

constexpr int kPerLane = kChunk / 32;   // rows a lane a pass

// Merge query qi's n = nprobe * chunks * k partial keys with one warp:
// the first partial (sorted, k keys) as the k best so far, then the rest
// 32 * kPerLane at a time through warp_merge; write its ids and distances.
// The partials and probes were written by other blocks: read past L1
// (__ldcg).  Up to 32 probes are read beside the first keys, one a lane,
// and taken from there.
__device__ __forceinline__ void merge_query(
    int qi, const Key* part, int n, const int* probes,
    const int* __restrict__ ids, int* __restrict__ out_nn,
    float* __restrict__ out_d, int nprobe, int block, int k) {
  const int lane = threadIdx.x & 31;
  const size_t at = static_cast<size_t>(qi) * n;
  const int* qp = probes + static_cast<size_t>(qi) * nprobe;
  const int lane_probe = lane < nprobe ? __ldcg(qp + lane) : 0;
  Key mine = lane < k ? __ldcg(part + at + lane) : kNoKey;
  for (int e0 = k; e0 < n; e0 += 32 * kPerLane) {
    Key key[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = e0 + lane + 32 * j;
      key[j] = e < n ? __ldcg(part + at + e) : kNoKey;
    }
    mine = warp_merge(key, mine, k);
  }
  const int p = key_pos(mine);
  const int rank = p / block;
  int lst = __shfl_sync(kFull, lane_probe, rank & 31);
  if (nprobe > 32 && p != kNoPos) lst = __ldcg(qp + rank);
  if (lane < k) {
    const size_t out = static_cast<size_t>(qi) * k + lane;
    out_nn[out] = p == kNoPos
                      ? -1
                      : __ldg(ids + static_cast<size_t>(lst) * block +
                              p % block);
    out_d[out] = key_dist(mine);
  }
}

// What every scan block is given, whichever its scorer.
struct Scan {
  const int* ids;       // (nlist, block)
  const int* member;    // (nlist, b), from the probe launch
  const int* probes;    // (b, nprobe), from the probe launch
  Key* part;            // (b * nprobe, chunks, k) partial keys
  int* arrived;         // (b) merge counters, zeroed by the probe launch
  int* out_nn;          // (b, k)
  float* out_d;         // (b, k)
  int b, block, nprobe, k, chunk, chunks, groups, span, round;
};

// Warp w's k best of (query, rank) `pair` over chunk c as a partial, and
// the merge where it is the query's last.  Where a query has one partial
// (nprobe 1, one chunk a list) it is the result: written at once, its ids
// from the staged rid.
__device__ __forceinline__ void finish_pair(Key mine, int pair, int c,
                                            const int* rid, const Scan& a) {
  const int lane = threadIdx.x & 31;
  const int qi = pair / a.nprobe;
  if (a.nprobe * a.chunks == 1) {
    if (lane < a.k) {
      const int p = key_pos(mine);
      const size_t out = static_cast<size_t>(qi) * a.k + lane;
      a.out_nn[out] = p == kNoPos ? -1 : rid[p];
      a.out_d[out] = key_dist(mine);
    }
    return;
  }
  const size_t at = (static_cast<size_t>(pair) * a.chunks + c) * a.k;
  if (lane < a.k) a.part[at + lane] = mine;
  // the last of a query's nprobe * chunks partials to land merges it
  __threadfence();   // every lane's partial is out before the count
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(a.arrived + qi, 1) == a.nprobe * a.chunks - 1;
    if (last) __threadfence();
  }
  if (__shfl_sync(kFull, last, 0))
    merge_query(qi, a.part, a.nprobe * a.chunks * a.k, a.probes, a.ids,
                a.out_nn, a.out_d, a.nprobe, a.block, a.k);
}

// The scorers.  Each carves its part of the block's shared memory and
// gives: kEarly (stage the chunk before the probes are in: it is small),
// kRounds and kFill (the spans, launch_search), setup() (before the
// probes are in), stage(), load_round() (a round's queries, block-wide),
// prepare() (once the chunk is in), begin(w) (warp w's query, once a
// pair) and score() (kPerLane rows a lane of up to kChunk rows from row r
// of the chunk: their keys, rows past the end kNoKey).

// Flat f32 rows: (|q|^2 + |x|^2) - 2 q.x.  Shared: a round's queries (kQ
// x d), |x|^2 (chunk), the rows (chunk x rs).  A chunk is one kChunk.
struct FlatArgs {
  const float* q;       // (b, d)
  const float* vecs;    // (nlist * block, d)
  int d;
};

template <bool kVec>
struct FlatRows {
  using Args = FlatArgs;
  static constexpr bool kEarly = false;
  static constexpr int kRounds = 2;   // rounds a block on average
  static constexpr int kFill = 0;     // blocks to split busy lists into
  Args a;
  int chunk, rs;
  float q2;
  float* qs;
  float* x2;
  float* rows;

  __device__ FlatRows(const Args& args, float* at, int chunk_rows, int, int)
      : a(args), chunk(chunk_rows), rs(kVec ? args.d + 4 : args.d + 1) {
    qs = at;
    x2 = qs + kQ * a.d;
    rows = x2 + chunk;
  }

  __device__ void setup() {}

  __device__ void stage(size_t slot0, int nrows) {
    stage_rows_async<kVec>(rows, a.vecs + slot0 * a.d, nrows, a.d, rs);
  }

  __device__ void load_round(const int* sel, int nq, int nprobe) {
    for (int e = threadIdx.x; e < nq * a.d; e += kThreads) {
      const int w = e / a.d;
      qs[e] = __ldg(a.q + static_cast<size_t>(sel[w] / nprobe) * a.d +
                    (e - w * a.d));
    }
  }

  __device__ void prepare(int nrows) {
    for (int row = threadIdx.x; row < nrows; row += kThreads)
      x2[row] = dot_seq<kVec>(rows + row * rs, rows + row * rs, a.d);
  }

  __device__ void begin(int w) {
    const float* qv = qs + w * a.d;
    q2 = dot_seq<kVec>(qv, qv, a.d);
  }

  // Full kChunk-row chunks (a list's last chunk too) score all kPerLane
  // rows unrolled, rows past the chunk's end reading stale shared memory
  // that is never used; smaller chunks (wide rows) guard each row.
  template <int N>
  __device__ void score(int w, int, int nrows, int base, const int* rid,
                        Key (&key)[N]) {
    const int lane = threadIdx.x & 31;
    const float* qv = qs + w * a.d;
    if (chunk == kChunk) {
      float acc[kPerLane];
      dots_n<kPerLane, kVec>(qv, rows, rs, lane, 32, a.d, acc);
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
            const float qx = dot_seq<kVec>(qv, rows + row * rs, a.d);
            dist = __fsub_rn(__fadd_rn(q2, x2[row]), __fmul_rn(2.0f, qx));
          }
          key[i] = make_key(dist, base + row);
        }
      }
    }
  }
};

// IVF-PQ codes: sum_s lut[s][code[s]].  Shared: a round's tables (round
// x m * ksub) and residuals (round x d), the decoded books (ksub * d,
// entry-minor: book[s][c][t] at (s * dsub + t) * ksub + c), the chunk's
// codes (chunk x m bytes), a chunk being up to kPqChunk rows, a whole
// list at the bench, so a (query, probe) builds its table once.  The
// tables come first: a code past ksub (the index build never writes one)
// reads inside the block's memory.  PQ distances are sums of squares from
// +0.0, never -0.0, as make_key needs.  kVec: codes copied and read as
// 4-byte words (m % 4 == 0, codes 4-byte aligned).
constexpr int kPqChunk = 4 * kChunk;

struct PqArgs {
  const float* q;        // (b, d)
  const float* cents;    // (nlist, d)
  const int8_t* codes;   // (nlist * block, m), values in [0, ksub)
  const int8_t* cb_q;    // (m, ksub, d / m)
  const float* cb_s;     // (m, ksub)
  int d, m, ksub;
};

template <bool kVec>
struct PqCodes {
  using Args = PqArgs;
  static constexpr bool kEarly = true;
  static constexpr int kRounds = 1;   // rounds a block on average
  static constexpr int kFill = 1024;  // blocks to split busy lists into
  Args a;
  int list, dsub, entries;
  float* lut;
  float* resid;
  float* books;
  int8_t* codes;

  __device__ PqCodes(const Args& args, float* at, int, int round, int l)
      : a(args), list(l), dsub(args.d / args.m), entries(args.m * args.ksub) {
    lut = at;
    resid = lut + round * entries;
    books = resid + round * a.d;
    codes = reinterpret_cast<int8_t*>(books + a.ksub * a.d);
  }

  // the books, read in cb_q's order (coalesced)
  __device__ void setup() {
    for (int e = threadIdx.x; e < a.ksub * a.d; e += kThreads) {
      const int sc = e / dsub;               // s * ksub + c
      const int t = e - sc * dsub;
      const int s = sc / a.ksub;
      books[(s * dsub + t) * a.ksub + (sc - s * a.ksub)] =
          __fmul_rn(static_cast<float>(__ldg(a.cb_q + e)), __ldg(a.cb_s + sc));
    }
  }

  __device__ void stage(size_t slot0, int nrows) {
    const int8_t* src = a.codes + slot0 * a.m;
    if (kVec) {
      for (int e = threadIdx.x; e < nrows * a.m / 4; e += kThreads)
        cp_async4(codes + 4 * e, src + 4 * e);
    } else {
      for (int e = threadIdx.x; e < nrows * a.m; e += kThreads)
        codes[e] = __ldg(src + e);
    }
  }

  // the round's residuals q - c[list]
  __device__ void load_round(const int* sel, int nq, int nprobe) {
    const float* cv = a.cents + static_cast<size_t>(list) * a.d;
    for (int e = threadIdx.x; e < nq * a.d; e += kThreads) {
      const int w = e / a.d;
      const int j = e - w * a.d;
      resid[e] = __fsub_rn(
          __ldg(a.q + static_cast<size_t>(sel[w] / nprobe) * a.d + j),
          __ldg(cv + j));
    }
  }

  __device__ void prepare(int) {}

  // warp w's table, 4 entries a lane at a time (independent chains)
  __device__ void begin(int w) {
    const int lane = threadIdx.x & 31;
    const int ksub = a.ksub;
    const float* r = resid + w * a.d;
    float* t = lut + w * entries;
    for (int e0 = lane; e0 < entries; e0 += 4 * 32) {
      const float* rp[4];
      const float* bp[4];
      float acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = min(e0 + 32 * i, entries - 1);
        const int s = e / ksub;
        rp[i] = r + s * dsub;
        bp[i] = books + s * dsub * ksub + (e - s * ksub);
        acc[i] = 0.0f;
      }
      for (int u = 0; u < dsub; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float diff = __fsub_rn(rp[i][u], bp[i][u * ksub]);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(diff, diff));
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e0 + 32 * i < entries) t[e0 + 32 * i] = acc[i];
    }
    __syncwarp();
  }

  // rows r + lane + 32 i (rows past the end read row r's codes, unused)
  template <int N>
  __device__ void score(int w, int r, int nrows, int base, const int* rid,
                        Key (&key)[N]) {
    const int lane = threadIdx.x & 31;
    const int m = a.m, ksub = a.ksub;
    const float* t = lut + w * entries;
    int at[kPerLane];
    float acc[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int row = lane + 32 * i;
      at[i] = (r + (row < nrows ? row : 0)) * m;
      acc[i] = 0.0f;
    }
    if (kVec) {
      const unsigned* cw = reinterpret_cast<const unsigned*>(codes);
      for (int s4 = 0; s4 < m; s4 += 4) {
        unsigned word[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) word[i] = cw[(at[i] + s4) / 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* ts = t + (s4 + j) * ksub;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i)
            acc[i] = __fadd_rn(acc[i], ts[(word[i] >> (8 * j)) & 0xffu]);
        }
      }
    } else {
      for (int s = 0; s < m; ++s) {
        const float* ts = t + s * ksub;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          acc[i] = __fadd_rn(
              acc[i], ts[static_cast<unsigned char>(codes[at[i] + s])]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int row = lane + 32 * i;
      key[i] = row < nrows
                   ? make_key(rid[row] >= 0 ? acc[i] : CUDART_INF_F,
                              base + row)
                   : kNoKey;
    }
  }
};

template <class S>
__global__ void __launch_bounds__(kThreads, 3)
scan_kernel(typename S::Args args, Scan a) {
  const int item = blockIdx.x / a.chunks;
  const int c = blockIdx.x - item * a.chunks;
  const int l = item / a.groups;
  const int q_lo = (item - l * a.groups) * a.span;
  const int q_hi = min(a.b, q_lo + a.span);
  const int r0 = c * a.chunk;
  const int nrows = min(a.chunk, a.block - r0);
  extern __shared__ float smem[];
  int* sel = reinterpret_cast<int*>(smem);          // kThreads
  int* rid = sel + kThreads;                        // chunk
  S s(args, reinterpret_cast<float*>(rid + a.chunk), a.chunk, a.round, l);
  __shared__ int warp_n[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t slot0 = static_cast<size_t>(l) * a.block + r0;
  const int* mrow = a.member + static_cast<size_t>(l) * a.b;
  auto stage = [&] {
    s.stage(slot0, nrows);
    for (int row = threadIdx.x; row < nrows; row += kThreads)
      cp_async4(rid + row, a.ids + slot0 + row);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // what does not depend on the probes (a barrier below publishes it)
  s.setup();
  if (S::kEarly) stage();
  bool issued = S::kEarly, staged = false;
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
      sel[at + __popc(m & ((1u << lane) - 1))] = qi * a.nprobe + rank - 1;
    __syncthreads();   // sel is written and warp_n read
    if (n == 0) continue;
    if (!issued) {
      // the chunk's copies go out first; the first round's queries
      // load meanwhile
      stage();
      issued = true;
    }
    for (int j0 = 0; j0 < n; j0 += a.round) {
      const int nq = min(a.round, n - j0);
      s.load_round(sel + j0, nq, a.nprobe);
      if (!staged) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        s.prepare(nrows);
        staged = true;
      }
      __syncthreads();
      if (warp < nq) {
        // warp w's (query, rank) over the chunk, kChunk rows at a time
        const int pair = sel[j0 + warp];
        const int base = (pair % a.nprobe) * a.block + r0;
        s.begin(warp);
        Key key[kPerLane];
        s.score(warp, 0, min(kChunk, nrows), base, rid, key);
        Key mine = warp_select(key, a.k);
        for (int r = kChunk; r < nrows; r += kChunk) {
          s.score(warp, r, min(kChunk, nrows - r), base + r, rid + r, key);
          mine = warp_merge(key, mine, a.k);
        }
        finish_pair(mine, pair, c, rid, a);
      }
      __syncthreads();   // sel and the round's shared memory are reused
    }
  }
  // a block none of whose queries probe its list leaves no copy in flight
  if (!staged) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

int check_shape(int b, int d, int nlist, int block, int nprobe, int k) {
  if (b < 0 || d < 1 || nlist < 1 || block < 1 || nprobe < 1 ||
      nprobe > nlist || k < 1 || k > kMaxK ||
      static_cast<long>(nlist) * block > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The sizes ops/retrieve.py::flat_plan / pq_plan give both launches.
struct Plan {
  int probe_queries, probe_rows;
  long probe_smem;
  int chunk, round;
  long scan_smem;
};

// The probe launch, then the scan as a programmatic dependent launch: its
// blocks start during the probe launch and wait for it at
// griddepcontrol.wait.  No memset, no host sync.
template <class S>
int launch_search(void (*probe)(const float*, const float*, int*, int*,
                                int*, int, int, int, int, int, int),
                  void (*scan)(typename S::Args, Scan),
                  const typename S::Args& args, const float* q,
                  const float* cents, const int* ids, void* nn, void* dist,
                  void* scratch, int b, int d, int nlist, int block,
                  int nprobe, int k, const Plan& p, void* stream) {
  int rc = check_shape(b, d, nlist, block, nprobe, k);
  if (rc) return rc;
  if (p.chunk < 1 || p.round < 1 || p.round > kQ || p.probe_rows < 1 ||
      p.probe_rows > kProbeRows || p.probe_rows % 4 ||
      p.probe_queries < 1 || p.probe_queries > kWarps || p.probe_smem < 1 ||
      p.probe_smem > kSmemLimit || p.scan_smem < 1 ||
      p.scan_smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long chunks = (block + p.chunk - 1) / p.chunk;
  // spans of the queries: about round * kRounds of a list's queries a
  // span; and, up to kFill blocks in all, as many as keep a list that
  // kSkew times the average of the queries probe to about one round a
  // block (the bench's busiest lists draw 2.4-5 times the average:
  // scripts/retrieve_phase_times.py)
  const long per_list = (static_cast<long>(b) * nprobe + nlist - 1) / nlist;
  const long span_queries = static_cast<long>(p.round) * S::kRounds;
  long groups = (per_list + span_queries - 1) / span_queries;
  long fill = (S::kFill + nlist * chunks - 1) / (nlist * chunks);
  const long skewed = (kSkew * per_list + span_queries - 1) / span_queries;
  if (fill > skewed) fill = skewed;
  if (groups < fill) groups = fill;
  if (groups > b) groups = b;
  if (groups < 1) groups = 1;
  const long span = (b + groups - 1) / groups;
  groups = (b + span - 1) / span;
  if (static_cast<long>(b) * nprobe * chunks * k > 0x7fffffffL ||
      static_cast<long>(nlist) * b > 0x7fffffffL ||
      nlist * groups * chunks > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t npairs = static_cast<size_t>(b) * nprobe;
  Scan a;
  a.part = static_cast<Key*>(scratch);   // first: 8-byte aligned
  int* probes = reinterpret_cast<int*>(a.part + npairs * chunks * k);
  int* member = probes + npairs;
  a.arrived = member + static_cast<size_t>(nlist) * b;
  a.ids = ids;
  a.member = member;
  a.probes = probes;
  a.out_nn = static_cast<int*>(nn);
  a.out_d = static_cast<float*>(dist);
  a.b = b;
  a.block = block;
  a.nprobe = nprobe;
  a.k = k;
  a.chunk = p.chunk;
  a.chunks = static_cast<int>(chunks);
  a.groups = static_cast<int>(groups);
  a.span = static_cast<int>(span);
  a.round = p.round;
  cudaError_t err = cudaFuncSetAttribute(
      probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.probe_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.scan_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  probe<<<(b + p.probe_queries - 1) / p.probe_queries, kThreads,
          p.probe_smem, s>>>(q, cents, probes, member, a.arrived, b, d,
                             nlist, nprobe, p.probe_queries, p.probe_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nlist * groups * chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.scan_smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scan, args, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 32-bit words of scratch a search takes: the partial keys (8-byte
// aligned, first), probes (b, nprobe), member (nlist, b) and the merge
// counters (b).
long scan_scratch_words(int b, int nlist, int block, int nprobe, int k,
                        int chunk) {
  if (chunk < 1) return 0;
  const long chunks = (block + chunk - 1) / chunk;
  const long pairs = static_cast<long>(b) * nprobe;
  return 2 * pairs * chunks * k + pairs + static_cast<long>(nlist) * b + b;
}

// neighbors nn (b, k) i32 and distances dist (b, k) f32 of a flat search.
// q (b, d), cents (nlist, d), vecs (nlist * block, d) f32; ids (nlist,
// block) i32.  scratch: scan_scratch_words(b, nlist, block, nprobe, k,
// chunk) words of device memory, 8-byte aligned.  The probe launch's
// queries a block, centroid rows a tile and bytes, the scan's rows a block
// and bytes come from ops/retrieve.py::flat_plan, the one place that sizes
// them; the launcher checks only the caps, and splits the queries into the
// scan's spans.
int retrieve_flat_launch(const void* q, const void* cents, const void* ids,
                         const void* vecs, void* nn, void* dist,
                         void* scratch, int b, int d, int nlist, int block,
                         int nprobe, int k, int probe_queries,
                         int probe_rows, long probe_smem, int chunk,
                         long scan_smem, void* stream) {
  // chunks of a multiple of 4 rows keep the rows' shared memory 16-byte
  // aligned
  if (chunk > kChunk || chunk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = {probe_queries, probe_rows, probe_smem, chunk, kQ,
                  scan_smem};
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(vecs) |
                    reinterpret_cast<uintptr_t>(cents)) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(cents);
  const int* id = static_cast<const int*>(ids);
  const FlatArgs args = {qf, static_cast<const float*>(vecs), d};
  if (vec)
    return launch_search<FlatRows<true>>(
        flat_probe_kernel<true>, scan_kernel<FlatRows<true>>, args, qf, cf,
        id, nn, dist, scratch, b, d, nlist, block, nprobe, k, p, stream);
  return launch_search<FlatRows<false>>(
      flat_probe_kernel<false>, scan_kernel<FlatRows<false>>, args, qf, cf,
      id, nn, dist, scratch, b, d, nlist, block, nprobe, k, p, stream);
}

// The same for IVF-PQ: codes (nlist * block, m) i8 with values in
// [0, ksub), cb_q (m, ksub, d / m) i8, cb_s (m, ksub) f32.  The scan's
// rows a block, queries a round and bytes come from
// ops/retrieve.py::pq_plan.
int retrieve_pq_launch(const void* q, const void* cents, const void* ids,
                       const void* codes, const void* cb_q, const void* cb_s,
                       void* nn, void* dist, void* scratch, int b, int d,
                       int nlist, int block, int nprobe, int k, int m,
                       int ksub, int probe_queries, int probe_rows,
                       long probe_smem, int chunk, int round, long scan_smem,
                       void* stream) {
  if (m < 1 || d % m || ksub < 2 || ksub > 127 || chunk > kPqChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = {probe_queries, probe_rows, probe_smem, chunk, round,
                  scan_smem};
  const bool vec_cents =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(cents) % 16 == 0;
  const bool vec_codes =
      m % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(cents);
  const int* id = static_cast<const int*>(ids);
  const PqArgs args = {qf, cf, static_cast<const int8_t*>(codes),
                       static_cast<const int8_t*>(cb_q),
                       static_cast<const float*>(cb_s), d, m, ksub};
  auto probe = vec_cents ? flat_probe_kernel<true> : flat_probe_kernel<false>;
  if (vec_codes)
    return launch_search<PqCodes<true>>(
        probe, scan_kernel<PqCodes<true>>, args, qf, cf, id, nn, dist,
        scratch, b, d, nlist, block, nprobe, k, p, stream);
  return launch_search<PqCodes<false>>(
      probe, scan_kernel<PqCodes<false>>, args, qf, cf, id, nn, dist,
      scratch, b, d, nlist, block, nprobe, k, p, stream);
}

}  // extern "C"
