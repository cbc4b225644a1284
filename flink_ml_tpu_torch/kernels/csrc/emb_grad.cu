// Hand-written Hopper (sm_90a) kernel for the routed embedding gradient of
// the Wide&Deep trainer (flink_ml_tpu_torch/ops/emb_grad.py::fold_runs).
//
// Replaces flink_ml_tpu/ops/emb_grad_pallas.py::fold_runs_fused
// (_fold_kernel).  Input: the per-slot gradient rows g (S, E) f32 already
// sorted by table row, and their sorted ids (S,) i32.  The segmented suffix
// fold runs P passes; pass k (offset 2^k) is
//   g[i] += (i + 2^k < S && ids[i + 2^k] == ids[i]) ? g[i + 2^k] : 0
// (rows past S read as 0 and never match), after which every run start
// holds its run's sum.  The addend is 0.0f where the ids differ, exactly as
// the plain version's `g + where(same, shifted, 0.0)`, so every output row
// equals the plain version bit for bit (a -0.0 row becomes +0.0 in both).
//
// Bound on the H100: bytes.  g read once and written once, ids read once:
// S * (8E + 4) bytes, ~110 MB at the Wide&Deep bench shape (S = 8192 * 26,
// E = 64), 0.033 ms at 3.35 TB/s; the adds are negligible.  The unfused
// fold (one launch per pass) moves that traffic P times.
//
// Design.  Row i's final value depends only on rows i .. i + 2^P - 1 (the
// TPU kernel's halo argument), and columns fold independently because the
// match depends only on the ids.  So a block stages a tile of T rows plus a
// halo of 2^P - 1 rows of a narrow column slice in shared memory, runs the
// P passes there (ping-pong buffers, one barrier per pass) and writes its T
// rows: the same tree, any S (the last tile is masked), no divisibility
// rule.  Pass k only computes the rows later passes still read (the window
// shrinks by 2^k each pass).  Slices are 64 columns wide, narrowed by
// halving until the window fits the shared-memory budget; a halo past what
// one column can stage (2^P > ~8K rows, runs of more than ~8K equal ids in
// one step) folds its first P0 passes in shared memory and each remaining
// pass as one streaming launch over device memory, which is still the same
// tree.  Halo rows are read by two neighbouring blocks; the second read
// mostly hits L2.  Narrow slices of wide rows load uncoalesced (a heavy
// hitter's 4K-row halo at E = 64 stages 2 columns per block): the simple
// form first, a faster one is later work.
//
// Every launcher returns cudaGetLastError() so the caller sees a refused
// launch.  Nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 64;                 // widest column slice
constexpr long kSmemBudget = 200L * 1024;    // dynamic shared bytes a block
constexpr long kTargetElems = 4096;          // elements per buffer when the
                                             // halo is small
constexpr int kMaxPasses = 30;

struct Plan {
  int ec;       // column slice width: a power of two dividing kThreads
  int tile;     // output rows per block (T)
  int window;   // staged rows (T + 2^p0 - 1)
  int p0;       // passes folded in shared memory
  long smem;    // dynamic shared bytes
  long tiles;   // blocks along the rows
  int slices;   // blocks along the columns
};

// two f32 buffers of window x ec and the window's ids
long smem_bytes(long window, int ec) { return window * (2L * ec + 1) * 4; }

Plan make_plan(long S, int E, int passes) {
  Plan p;
  // the most passes whose halo still leaves a one-column window at least
  // half useful (T >= 2^p0)
  p.p0 = passes;
  while (p.p0 > 1 && smem_bytes((2L << p.p0) - 1, 1) > kSmemBudget) --p.p0;
  const long halo = (1L << p.p0) - 1;
  int ec = 1;
  while (ec < E && ec < kMaxCols) ec <<= 1;
  long window;
  for (;;) {
    window = kTargetElems / ec;
    if (window < 2 * halo + 1) window = 2 * halo + 1;
    if (smem_bytes(window, ec) <= kSmemBudget || ec == 1) break;
    ec >>= 1;
  }
  if (window > S + halo) window = S + halo;   // one tile covers every row
  p.ec = ec;
  p.window = static_cast<int>(window);
  p.tile = static_cast<int>(window - halo);
  p.smem = smem_bytes(window, ec);
  p.tiles = (S + p.tile - 1) / p.tile;
  p.slices = (E + ec - 1) / ec;
  return p;
}

// One block: rows [t0, t0 + tile) of columns [c0, c0 + ec), staged with the
// following window - tile rows, folded `passes` times in shared memory.
__global__ void __launch_bounds__(kThreads)
fold_tile_kernel(const float* __restrict__ g, const int* __restrict__ ids,
                 float* __restrict__ out, long S, int E, int ec, int tile,
                 int window, int passes) {
  extern __shared__ float smem[];
  float* buf0 = smem;
  float* buf1 = smem + static_cast<size_t>(window) * ec;
  int* sid =
      reinterpret_cast<int*>(smem + 2 * static_cast<size_t>(window) * ec);
  const long t0 = static_cast<long>(blockIdx.x) * tile;
  const int c0 = blockIdx.y * ec;
  const int col = threadIdx.x % ec;             // ec divides kThreads
  const int r_first = threadIdx.x / ec;
  const int r_step = kThreads / ec;
  const bool on = c0 + col < E;                 // ragged last slice

  for (int r = threadIdx.x; r < window; r += kThreads) {
    const long gr = t0 + r;
    sid[r] = gr < S ? ids[gr] : 0;              // never compared past S
  }
  if (on) {
    for (int r = r_first; r < window; r += r_step) {
      const long gr = t0 + r;
      buf0[r * ec + col] = gr < S ? g[gr * E + c0 + col] : 0.0f;
    }
  }
  __syncthreads();

  float* src = buf0;
  float* dst = buf1;
  const long span = 1L << passes;
  for (int k = 0; k < passes; ++k) {
    const int off = 1 << k;
    // rows the remaining passes (and the output) still read
    const int limit = static_cast<int>(tile + span - (2L << k));
    if (on) {
      for (int r = r_first; r < limit; r += r_step) {
        float add = 0.0f;
        if (t0 + r + off < S && sid[r + off] == sid[r])
          add = src[(r + off) * ec + col];
        dst[r * ec + col] = src[r * ec + col] + add;
      }
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  if (on) {
    for (int r = r_first; r < tile; r += r_step) {
      const long gr = t0 + r;
      if (gr < S) out[gr * E + c0 + col] = src[r * ec + col];
    }
  }
}

// One fold pass over device memory (the passes past the shared-memory
// halo): dst[i] = src[i] + (match ? src[i + off] : 0).
__global__ void __launch_bounds__(kThreads)
fold_pass_kernel(const float* __restrict__ src, const int* __restrict__ ids,
                 float* __restrict__ dst, long S, int E, long off) {
  const long n = S * E;
  for (long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * kThreads) {
    const long r = i / E;
    float add = 0.0f;
    if (r + off < S && ids[r + off] == ids[r]) add = src[i + off * E];
    dst[i] = src[i] + add;
  }
}

}  // namespace

extern "C" {

// Passes fold_launch runs in shared memory; the caller passes a scratch
// buffer of S x E floats when this is less than `passes`.
int emb_fold_shared_passes(long S, int E, int passes) {
  if (S < 1 || E < 1 || passes < 1 || passes > kMaxPasses) return 0;
  return make_plan(S, E, passes).p0;
}

// out (S, E) = all `passes` fold passes of g (S, E) under ids (S,).
// g, ids, out, scratch: device pointers; g and out must not overlap.
int emb_fold_launch(const void* g, const void* ids, void* out, void* scratch,
                    long S, int E, int passes, void* stream) {
  if (S < 0 || E < 1 || passes < 1 || passes > kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaGetLastError());
  const Plan p = make_plan(S, E, passes);
  const int rest = passes - p.p0;
  if (rest > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  // the streaming passes ping-pong; start where they end on `out`
  float* first = rest % 2 == 1 ? sc : o;
  cudaError_t err = cudaFuncSetAttribute(
      fold_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(p.tiles), static_cast<unsigned>(p.slices));
  fold_tile_kernel<<<grid, kThreads, p.smem, s>>>(
      static_cast<const float*>(g), static_cast<const int*>(ids), first, S,
      E, p.ec, p.tile, p.window, p.p0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* src = first;
  float* dst = first == o ? sc : o;
  const long n = S * E;
  long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132L * 16) blocks = 132L * 16;
  for (int k = p.p0; k < passes; ++k) {
    fold_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        src, static_cast<const int*>(ids), dst, S, E, 1L << k);
    float* t = src;
    src = dst;
    dst = t;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
