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
// E = 64), 0.033 ms at 3.35 TB/s; the adds are negligible.
//
// Design: passes grouped by stride.  Levels k >= b pair row j with row
// j + 2^k; write j = s * 2^b + r: those levels are the same masked
// shift-add over super-rows s (stride 2^b rows) at a fixed residue r, with
// offsets 2^(k - b).  So the P levels run in groups of at most L =
// kGroupLevels levels, one launch of one kernel per group, ceil(P / L)
// launches: group g folds levels gL .. gL + L - 1 over
// super-rows of stride 2^(gL), each output row depending on the next
// 2^L - 1 super-rows only (the TPU kernel's halo argument).  Every group
// does the plain version's adds in the same order, so the bits cannot
// change.  Groups ping-pong between `out` and the caller's scratch, the
// last one writing `out`.
// - A block stages a window of super-rows (a tile plus the halo) of one
//   piece of the super-row in shared memory: the whole row where it fits
//   (E = 64: 256 bytes), or, where a row is narrower than 32 floats, the
//   run of adjacent residues, which is contiguous, so every staged piece is
//   >= 128 bytes and loads are 16-byte cp.async where the addresses allow.
//   Only a row past 1 KB, or a deep halo, narrows the piece (by halving).
// - The window is sized for six blocks an SM (36 KB; three and nine
//   measured slower), so some blocks' loads are in flight while others
//   fold, and grown towards four halos where the halo is deep (heavy
//   hitters): group 0 at P = 3 re-reads 7 of each 139 rows (from L2), a
//   deep group a quarter.
// - The levels run in place in one shared buffer: a level computes only
//   the rows later levels still read (the window shrinks by 2^k each
//   level), and writes only the rows that match, which at the deep levels
//   of a heavy hitter are few (ids are sorted, so the match of every level
//   is worked out once per super-row, as bits).  The "+ 0.0" of a row that
//   does not match is applied where its value is next read (see
//   fold_levels), so the bits stay the plain version's.  The tile is
//   written with 16-byte stores.
//
// Every launcher returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape it refuses) so the caller sees a refused launch.  Nothing here
// synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPasses = 30;
// Levels a launch (halo 2^L - 1 = 127 super-rows).  7 took the least time
// in total over the heavy-hitter and deep routes at E = 64 and 1, with 6 and
// 8 beside it (scripts/fold_phase_times.py), though not on every route:
// heavy E = 1 ran faster at 8, deep E = 1 at 6 and at 8.
constexpr int kGroupLevels = 7;
constexpr int kPieceFloats = 32;            // >= 128 bytes a staged piece
constexpr int kMaxPiece = 256;              // widest piece: 1 KB
constexpr long kSmemTarget = 36L * 1024;    // six blocks an SM
constexpr long kSmemDeep = 110L * 1024;     // the most for a deep halo
constexpr long kSmemBudget = 200L * 1024;   // one block: the deepest halo
constexpr long kMinBlocks = 4 * 132;        // four blocks an SM where the
                                            // rows allow

struct Group {
  long stride;   // rows between super-rows: 2^base
  int levels;    // levels folded by this launch
  int R;         // adjacent residues a piece covers
  int width;     // floats a piece (<= R * E)
  int cslices;   // pieces across one R * E segment
  int window;    // staged super-rows
  int tile;      // output super-rows a block
  long smem;     // dynamic shared bytes
  long slices;   // blocks across the residues and columns
  long blocks;   // slices * tiles
};

// one f32 buffer of window x width, the window's ids and match bits
long group_smem(long window, int width, int R) {
  return window * (static_cast<long>(width) + 2L * R) * 4;
}

Group make_group(long S, int E, int base, int levels) {
  Group p;
  p.stride = 1L << base;
  p.levels = levels;
  int R = 1;
  while (R < p.stride && R * E < kPieceFloats) R <<= 1;
  p.R = R;
  const long seg = static_cast<long>(R) * E;
  const long halo = (1L << levels) - 1;
  int width = static_cast<int>(seg < kMaxPiece ? seg : kMaxPiece);
  while (width > 4 && group_smem(2 * halo + 1, width, R) > kSmemBudget)
    width = (width + 1) / 2;
  if (width > 4) width &= ~3;               // 16-byte pieces where wide
  p.width = width;
  p.cslices = static_cast<int>((seg + width - 1) / width);
  p.slices = (p.stride / R) * p.cslices;
  const long per_row = group_smem(1, width, R);
  long window = kSmemTarget / per_row;
  if (window < 4 * (halo + 1)) {
    const long deep = kSmemDeep / per_row;
    window = deep < 4 * (halo + 1) ? deep : 4 * (halo + 1);
  }
  if (window < 2 * halo + 1) window = 2 * halo + 1;
  const long sup = (S + p.stride - 1) / p.stride;   // super-rows
  // enough blocks to fill the card where the rows allow
  const long want = (kMinBlocks + p.slices - 1) / p.slices;
  const long cap = (sup + want - 1) / want + halo;
  if (window > cap) window = cap > 2 * halo + 1 ? cap : 2 * halo + 1;
  if (window > sup + halo) window = sup + halo;     // one tile covers all
  p.window = static_cast<int>(window);
  p.tile = static_cast<int>(window - halo);
  p.smem = group_smem(window, width, R);
  p.blocks = p.slices * ((sup + p.tile - 1) / p.tile);
  return p;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ float plus_zero(float x) {
  return __fadd_rn(x, 0.0f);
}

__device__ __forceinline__ float4 plus_zero(float4 x) {
  return make_float4(__fadd_rn(x.x, 0.0f), __fadd_rn(x.y, 0.0f),
                     __fadd_rn(x.z, 0.0f), __fadd_rn(x.w, 0.0f));
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

constexpr int kBatch = 4;   // elements a thread a batch of a level

// The `levels` levels of a staged window in place: buf holds window x n
// elements of T (q floats each), match the levels' bits per (super-row,
// residue), act the nact super-rows that match at some level, ascending.
// See the kernel's note.
template <typename T>
__device__ __forceinline__ void fold_levels(T* buf, const int* match,
                                            const int* act, int nact, int n,
                                            int q, int levels, int tile,
                                            int R, int E, int c0) {
  const int shift = (n & (n - 1)) == 0 ? __ffs(n) - 1 : -1;
  const int span = 1 << levels;
  const int total = nact * n;
  for (int k = 0; k < levels; ++k) {
    const int off = 1 << k;
    // super-rows the remaining levels (and the output) still read
    const int limit = tile + span - (2 << k);
    for (int e0 = 0; e0 < total; e0 += kThreads * kBatch) {
      T v[kBatch];
      int at[kBatch];
      bool any = false;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int e = e0 + t * kThreads + threadIdx.x;
        at[t] = -1;
        if (e < total) {
          const int u = shift >= 0 ? e >> shift : e / n;
          const int w = e - u * n;
          const int sr = act[u];
          const int rr = R == 1 ? 0 : (c0 + q * w) / E;
          const int bits = sr < limit ? match[sr * R + rr] : 0;
          if ((bits >> k) & 1) {
            const int x = sr * n + w;
            T a = buf[x];
            T b = buf[x + off * n];
            if (k > 0 && !((bits >> (k - 1)) & 1)) a = plus_zero(a);
            if (k > 0 && !((match[(sr + off) * R + rr] >> (k - 1)) & 1))
              b = plus_zero(b);
            v[t] = add(a, b);
            at[t] = x;
            any = true;
          }
        }
      }
      if (__syncthreads_or(any)) {
#pragma unroll
        for (int t = 0; t < kBatch; ++t)
          if (at[t] >= 0) buf[at[t]] = v[t];
        __syncthreads();
      }
    }
  }
}

// One block: super-rows [s0, s0 + tile) of one piece (residues r0 ..
// r0 + R - 1, floats c0 .. c0 + width of their contiguous segment), staged
// with the following window - tile super-rows, folded `levels` times at
// offsets 1, 2, 4, ... super-rows.  `aligned`: src and dst are 16-byte
// aligned.
__global__ void __launch_bounds__(kThreads)
fold_group_kernel(const float* __restrict__ src, const int* __restrict__ ids,
                  float* __restrict__ dst, long S, int E, long stride,
                  int levels, int R, int width_max, int cslices, int window,
                  int tile, long slices, int aligned) {
  extern __shared__ float smem[];
  const long t = blockIdx.x / slices;
  const long sl = blockIdx.x - t * slices;
  const long rgrp = sl / cslices;
  const int c0 = static_cast<int>(sl - rgrp * cslices) * width_max;
  const long r0 = rgrp * R;
  const int seg = R * E;
  const int W = min(width_max, seg - c0);
  const long s0 = t * tile;
  float* buf = smem;
  int* sid = reinterpret_cast<int*>(smem + static_cast<size_t>(window) *
                                               width_max);
  // bit k of match[sr * R + rr]: level k adds super-row sr + 2^k
  int* match = sid + static_cast<size_t>(window) * R;
  const long row0 = s0 * stride + r0;           // row of (sr 0, residue 0)
  const long rowf = stride * E;                 // floats a super-row step
  const long base = row0 * E + c0;              // float of (sr 0, w 0)
  // the residue (0 .. R - 1) of a piece's float w, and its row at sr
  auto residue = [=](int w) { return R == 1 ? 0 : (c0 + w) / E; };
  auto row_of = [=](int sr, int w) {
    return row0 + static_cast<long>(sr) * stride + residue(w);
  };

  const bool vec = aligned && W % 4 == 0 && rowf % 4 == 0 && base % 4 == 0;
  const int step = vec ? 4 : 1;
  {
    const int lanes = kThreads * step;
    const int dsr = lanes / W, dw = lanes - (lanes / W) * W;
    int sr = threadIdx.x * step / W;
    int w = threadIdx.x * step - sr * W;
    while (sr < window) {
      const long gsr = static_cast<long>(sr) * rowf;
      float* d = buf + sr * W + w;
      // rows ascend along a piece: the last float's row decides
      if (vec && row_of(sr, w + 3) < S) {
        cp_async16(d, src + base + gsr + w);
      } else {
        for (int j = 0; j < step; ++j) {
          if (row_of(sr, w + j) < S)
            cp_async4(d + j, src + base + gsr + w + j);
          else
            d[j] = 0.0f;
        }
      }
      sr += dsr;
      w += dw;
      if (w >= W) {
        w -= W;
        ++sr;
      }
    }
  }
  // the ids ride the same copy group (never compared past S)
  for (int i = threadIdx.x; i < window * R; i += kThreads) {
    const int sr = i / R;
    const long row = row0 + static_cast<long>(sr) * stride + (i - sr * R);
    if (row < S)
      cp_async4(reinterpret_cast<float*>(sid + i),
                reinterpret_cast<const float*>(ids + row));
    else
      sid[i] = 0;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // the match of every level, once per (super-row, residue): ids are
  // sorted, so a super-row's match at a level never depends on the data
  for (int i = threadIdx.x; i < window * R; i += kThreads) {
    const int sr = i / R;
    const int rr = i - sr * R;
    int bits = 0;
    for (int k = 0; k < levels; ++k) {
      const int o = sr + (1 << k);
      if (o < window && row0 + static_cast<long>(o) * stride + rr < S &&
          sid[o * R + rr] == sid[i])
        bits |= 1 << k;
    }
    match[i] = bits;
  }
  __syncthreads();

  // The levels run in place over act, the super-rows that match at some
  // level, ascending (compacted into the ids' space, no longer read), in
  // batches of kBatch elements a thread: a batch reads its rows and their
  // partners (at or past the batch, not yet written), then, after a
  // barrier, writes the rows that match; a batch where nothing matches
  // writes nothing.  A row that does not match at a level keeps its value,
  // so the level's "+ 0.0" (which turns -0.0 into +0.0, as the plain
  // version's `g + where(same, shifted, 0.0)` does) is applied where the
  // value is next read: at the row's or a partner's next match, or at the
  // output, wherever the level before did not match it.
  int* act = sid;
  __shared__ int warp_hits[kThreads / 32];
  int nact = 0;
  for (int c = 0; c < window; c += kThreads) {
    const int sr = c + threadIdx.x;
    bool hit = false;
    if (sr < window)
      for (int rr = 0; rr < R; ++rr) hit |= match[sr * R + rr] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_hits[warp] = __popc(m);
    __syncthreads();
    int before = 0, all = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      before += i < warp ? warp_hits[i] : 0;
      all += warp_hits[i];
    }
    if (hit)
      act[nact + before + __popc(m & ((1u << (threadIdx.x & 31)) - 1))] = sr;
    nact += all;
    __syncthreads();
  }
  const bool four = W % 4 == 0 && (R == 1 || E % 4 == 0);
  if (four)
    fold_levels<float4>(reinterpret_cast<float4*>(buf), match, act, nact,
                        W / 4, 4, levels, tile, R, E, c0);
  else
    fold_levels<float>(buf, match, act, nact, W, 1, levels, tile, R, E, c0);

  {
    const int lanes = kThreads * step;
    const int dsr2 = lanes / W, dw2 = lanes - (lanes / W) * W;
    int sr = threadIdx.x * step / W;
    int w = threadIdx.x * step - sr * W;
    while (sr < tile) {
      const long gsr = static_cast<long>(sr) * rowf;
      const float* s = buf + sr * W + w;
      // the last level's "+ 0.0" where it did not match
      auto out = [=](int j, float x) {
        return (match[sr * R + residue(w + j)] >> (levels - 1)) & 1
                   ? x
                   : plus_zero(x);
      };
      if (vec && row_of(sr, w + 3) < S) {
        const float4 x = *reinterpret_cast<const float4*>(s);
        *reinterpret_cast<float4*>(dst + base + gsr + w) =
            make_float4(out(0, x.x), out(1, x.y), out(2, x.z), out(3, x.w));
      } else {
        for (int j = 0; j < step; ++j) {
          if (row_of(sr, w + j) < S) dst[base + gsr + w + j] = out(j, s[j]);
        }
      }
      sr += dsr2;
      w += dw2;
      if (w >= W) {
        w -= W;
        ++sr;
      }
    }
  }
}

bool valid(long S, int E, int passes) {
  return S >= 0 && E >= 1 && passes >= 1 && passes <= kMaxPasses;
}

}  // namespace

extern "C" {

// Levels a launch: a call with more passes needs the scratch.
int emb_fold_group_levels() { return kGroupLevels; }

// out (S, E) = all `passes` fold passes of g (S, E) under ids (S,), in
// ceil(passes / kGroupLevels) launches.  g, ids, out, scratch: device
// pointers; g and out must not overlap; scratch (S x E floats) is needed
// only when passes > kGroupLevels.
int emb_fold_launch(const void* g, const void* ids, void* out, void* scratch,
                    long S, int E, int passes, void* stream) {
  if (!valid(S, E, passes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaGetLastError());
  const int groups = (passes + kGroupLevels - 1) / kGroupLevels;
  if (groups > 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fold_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBudget));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* src = static_cast<const float*>(g);
  for (int gi = 0; gi < groups; ++gi) {
    const int base = gi * kGroupLevels;
    const Group p =
        make_group(S, E, base, min(kGroupLevels, passes - base));
    if (p.blocks > 0x7fffffffL || p.smem > kSmemBudget)
      return static_cast<int>(cudaErrorInvalidValue);
    // ping-pong so that the last group writes `out`
    float* dst = static_cast<float*>((groups - 1 - gi) % 2 == 0 ? out
                                                                : scratch);
    const int aligned =
        (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
                % 16 == 0;
    fold_group_kernel<<<static_cast<unsigned>(p.blocks), kThreads, p.smem,
                        s>>>(src, static_cast<const int*>(ids), dst, S, E,
                             p.stride, p.levels, p.R, p.width, p.cslices,
                             p.window, p.tile, p.slices, aligned);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
