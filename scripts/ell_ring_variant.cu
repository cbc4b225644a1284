// The fused ELL scatter (kernel 2 of
// flink_ml_tpu_torch/kernels/csrc/ell_scatter.cu) as a persistent grid over
// a ring of bulk-copied rows: a design that was measured and not taken.
// scripts/ell_phase_times.py builds this file (it includes the production
// source, whose helpers it shares) and times it beside the production
// kernel, bit for bit against the same plain version.
//
// Design: as many 256-thread blocks as fit on the SMs walk groups of 8
// table rows through a ring of kStages shared-memory stages; one thread
// fills a stage with Hopper bulk copies (cp.async.bulk, one per array: a
// group's rows are contiguous) completing on the stage's mbarrier, the
// warps (one per row) gather r_ext, run the cumsum and pick from shared
// memory, and a block barrier releases the stage for its refill.  At the
// LR main path's 8192 rows every block holds at most 4 groups, so the ring
// never refills there: it serializes up to 4 groups a block where the
// production kernel's single wave of 1024 blocks has every row in flight.

#include "../flink_ml_tpu_torch/kernels/csrc/ell_scatter.cu"

namespace {

constexpr int kStages = 4;              // ring depth
constexpr int kRowBytes = kWidth * 4;
constexpr int kGroupBytes = kWarps * kRowBytes;   // one array of a stage

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src),
      "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Shared memory of the ring: kStages stages of `narr` arrays (src, pos,
// mask, w[, val]) of kWarps rows each, then one csum row per warp, then
// one mbarrier per stage.
__host__ __device__ constexpr int ring_smem_bytes(int narr) {
  return kStages * narr * kGroupBytes + kWarps * kRowBytes + kStages * 8;
}

__global__ void __launch_bounds__(kThreads)
ell_scatter_ring_kernel(const float* w, const float* __restrict__ r_ext,
                        int r_len, const int* src, const int* pos,
                        const float* mask, const float* val, float neg_lr,
                        float* out, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int narr = val != nullptr ? 5 : 4;
  const int stage_bytes = narr * kGroupBytes;
  float* csum_rows = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(csum_rows + kWarps * kWidth);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (rows + kWarps - 1) / kWarps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Fill the stage of this block's `it`-th group (thread 0 only).
  auto issue = [&](int it) {
    const int g = blockIdx.x + it * gridDim.x;
    if (g >= groups) return;
    unsigned char* st = smem + (it % kStages) * stage_bytes;
    const int64_t base = static_cast<int64_t>(g) * kWarps * kWidth;
    const uint32_t bytes = min(kWarps, rows - g * kWarps) * kRowBytes;
    uint64_t* bar = full + it % kStages;
    mbar_expect_tx(bar, bytes * narr);
    bulk_load(st, src + base, bytes, bar);
    bulk_load(st + kGroupBytes, pos + base, bytes, bar);
    bulk_load(st + 2 * kGroupBytes, mask + base, bytes, bar);
    bulk_load(st + 3 * kGroupBytes, w + base, bytes, bar);
    if (val != nullptr) bulk_load(st + 4 * kGroupBytes, val + base, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int it = 0; it < kStages; ++it) issue(it);
  }

  float* csum = csum_rows + warp * kWidth;
  for (int it = 0;; ++it) {
    const int g = blockIdx.x + it * gridDim.x;
    if (g >= groups) break;
    mbar_wait(full + it % kStages, (it / kStages) & 1);
    const int row = g * kWarps + warp;
    if (row < rows) {
      const unsigned char* st = smem + (it % kStages) * stage_bytes;
      const int* s_src = reinterpret_cast<const int*>(st) + warp * kWidth;
      const int* s_pos =
          reinterpret_cast<const int*>(st + kGroupBytes) + warp * kWidth;
      const float* s_mask =
          reinterpret_cast<const float*>(st + 2 * kGroupBytes) +
          warp * kWidth;
      const float* s_w =
          reinterpret_cast<const float*>(st + 3 * kGroupBytes) +
          warp * kWidth;
      const float* s_val =
          reinterpret_cast<const float*>(st + 4 * kGroupBytes) +
          warp * kWidth;
      float u[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int m = s_src[lane + 32 * j];
        u[j] = static_cast<unsigned>(m) < static_cast<unsigned>(r_len)
                   ? __ldg(r_ext + m) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        u[j] = __fmul_rn(neg_lr, u[j]);
        if (val != nullptr) u[j] = __fmul_rn(u[j], s_val[lane + 32 * j]);
      }
      row_cumsum(u, lane);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) csum[lane + 32 * j] = u[j];
      __syncwarp();
      float gp[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int l = lane + 32 * j;
        const int p = min(max(s_pos[l], 0), kWidth - 1);
        gp[j] = __fmul_rn(csum[p], s_mask[l]);
      }
      float sh[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        sh[j] = __shfl_sync(kFull, gp[j], (lane - 1) & 31);
      const int64_t base = static_cast<int64_t>(row) * kWidth;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int l = lane + 32 * j;
        const float gs = lane >= 1 ? sh[j] : (j > 0 ? sh[j - 1] : 0.0f);
        out[base + l] = __fsub_rn(__fadd_rn(s_w[l], gp[j]), gs);
      }
    }
    // every warp is done with this stage (and its csum row): refill it
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(it + kStages);
    }
  }
}

// Blocks of the ring kernel that fit on the card at once (per device and
// ring width, looked up once).
int ring_grid(int narr, int groups, int* err) {
  static int cached[16][2];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err) return 0;
  int* slot = dev < 16 ? &cached[dev][narr - 4] : nullptr;
  if (slot == nullptr || *slot == 0) {
    const int bytes = ring_smem_bytes(narr);
    int sms = 0, per_sm = 0;
    if ((*err = cudaFuncSetAttribute(
             ell_scatter_ring_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             ring_smem_bytes(5))) ||
        (*err = cudaFuncSetAttribute(
             ell_scatter_ring_kernel,
             cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) ||
        (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) ||
        (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ell_scatter_ring_kernel, kThreads, bytes)))
      return 0;
    const int total = sms * (per_sm > 0 ? per_sm : 1);
    if (slot == nullptr) return min(groups, total);
    *slot = total;
  }
  return min(groups, *slot);
}

}  // namespace

extern "C" int ell_ring_fused_launch(const void* w, const void* r_ext,
                                     int r_len, const void* src,
                                     const void* pos, const void* mask,
                                     const void* val, float lr, void* out,
                                     int rows, void* stream) {
  if (rows > 0) {
    const int narr = val != nullptr ? 5 : 4;
    int err = 0;
    const int grid = ring_grid(narr, blocks_for(rows), &err);
    if (err) return err;
    ell_scatter_ring_kernel<<<grid, kThreads, ring_smem_bytes(narr),
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const float*>(r_ext),
        r_len, static_cast<const int*>(src), static_cast<const int*>(pos),
        static_cast<const float*>(mask), static_cast<const float*>(val),
        -lr, static_cast<float*>(out), rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ring's grid for `groups` groups of 8 rows, or -(CUDA error).
extern "C" int ell_ring_grid(int with_val, int groups) {
  int err = 0;
  const int grid = ring_grid(with_val ? 5 : 4, groups, &err);
  return err ? -err : grid;
}
