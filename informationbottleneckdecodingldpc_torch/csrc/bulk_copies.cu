// P4: the cost of one bulk copy and of one wait for copies to complete, on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU probe of the JAX reference's
// scripts/dma_probe.py: build (waves of 512 dynamic DMAs, scatter VMEM -> HBM
// at offsets from an SMEM table, or stage HBM -> VMEM) and build_tiny_loops
// (the same waves issued and waited for in loops of a few entries each).
// Here a copy is one cp.async.bulk issued by one thread, and the tables
// (kernels/bulk_copies.py copy_tables) give each copy its device-memory row
// (a random permutation of slots max(L, 4 KB) apart, so no two copies of a
// wave touch the same bytes) and its shared-memory row in a 192 KB region
// (copy k at slot k mod slots). Block b takes row b of the device-memory
// table; the block loads its tables into shared memory first, as the TPU
// kept them in SMEM.
//
//   scatter  shared -> global: the block loads its 192 KB image from device
//            memory, then thread 0 issues every wave's copies in bulk groups,
//            one commit_group and wait_group per `group` copies;
//   stage    global -> shared: thread 0 issues `group` copies on one
//            mbarrier phase (arrive.expect_tx of their bytes) and waits for
//            it before the next group. A phase counts at most 2^20 - 1
//            bytes and two copies in flight into one slot leave it
//            undefined, so a group is at most min(entries, slots,
//            (2^20 - 1) / L) copies (the TPU probe let 4 race into a slot,
//            since it only timed them). At the end every thread adds up the
//            region, zeroed at the start: one int32 sum per block.
//
// What bounds it: at small L the issue of a copy by one thread (table
// reads, address arithmetic, the copy instruction) and the round trip of a
// wait; at large L device-memory bandwidth (3.35 TB/s on the data sheet),
// which one SM's copy engine cannot reach alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowBytes = 512;
constexpr int kMaxWave = 512;

enum Direction { kScatter = 0, kStage = 1 };

struct Copies {
  const int32_t* dst_rows;   // [blocks][wave] device-memory rows
  const int32_t* smem_rows;  // [wave] rows in the shared region
  int copy_bytes;
  int wave;
  int waves;
  int group;                 // copies per wait
  int region_bytes;
};

__device__ __forceinline__ void load_tables(const Copies& c, int32_t* dst, int32_t* smem) {
  for (int k = threadIdx.x; k < c.wave; k += kThreads) {
    dst[k] = c.dst_rows[blockIdx.x * c.wave + k];
    smem[k] = c.smem_rows[k];
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(Copies c, const int4* image, uint8_t* target) {
  extern __shared__ __align__(128) uint8_t region[];
  __shared__ int32_t dst[kMaxWave], smem[kMaxWave];
  load_tables(c, dst, smem);
  int4* r = reinterpret_cast<int4*>(region);
  for (int i = threadIdx.x; i < c.region_bytes / 16; i += kThreads) r[i] = image[i];
  bulk::fence_proxy_async();  // the image's generic stores before the copies read it
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 0; w < c.waves; ++w) {
    int open = 0;
    for (int k = 0; k < c.wave; ++k) {
      bulk::store(target + (long long)dst[k] * kRowBytes, region + smem[k] * kRowBytes,
                  c.copy_bytes);
      if (++open == c.group || k + 1 == c.wave) {
        bulk::commit();
        bulk::wait_all();
        open = 0;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    stage_kernel(Copies c, const uint8_t* source, int32_t* out) {
  extern __shared__ __align__(128) uint8_t region[];
  __shared__ int32_t dst[kMaxWave], smem[kMaxWave];
  __shared__ uint64_t bar;
  load_tables(c, dst, smem);
  int4* r = reinterpret_cast<int4*>(region);
  for (int i = threadIdx.x; i < c.region_bytes / 16; i += kThreads) r[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) bulk::init(&bar, 1);
  bulk::fence_proxy_async();  // the zeroing before the copies overwrite it
  __syncthreads();
  const int waits = (c.wave + c.group - 1) / c.group * c.waves;
  if (threadIdx.x == 0) {
    uint32_t parity = 0;
    for (int w = 0; w < c.waves; ++w) {
      for (int k0 = 0; k0 < c.wave; k0 += c.group) {
        const int n = min(c.group, c.wave - k0);
        bulk::arrive_expect_tx(&bar, uint32_t(n) * c.copy_bytes);
        for (int k = k0; k < k0 + n; ++k)
          bulk::load(region + smem[k] * kRowBytes, source + (long long)dst[k] * kRowBytes,
                     c.copy_bytes, &bar);
        bulk::wait(&bar, parity);
        parity ^= 1;
      }
    }
  }
  __syncthreads();
  if (waits > 0) bulk::wait(&bar, (waits - 1) & 1);  // every thread acquires the last phase
  const int4* v = reinterpret_cast<const int4*>(region);
  uint32_t sum = 0;
  for (int i = threadIdx.x; i < c.region_bytes / 16; i += kThreads) {
    const int4 x = v[i];
    sum += uint32_t(x.x) + uint32_t(x.y) + uint32_t(x.z) + uint32_t(x.w);
  }
  sum = bulk::block_sum(sum);
  if (threadIdx.x == 0) out[blockIdx.x] = int32_t(sum);
}

}  // namespace

extern "C" {

int bulk_copies_max_wave() { return kMaxWave; }

// `waves` waves of `wave` copies of `copy_bytes` per block on `blocks`
// blocks, `group` copies per wait. Direction 0 (scatter): the blocks load
// `data` (the `region_bytes` image) and copy it into `target`. Direction 1
// (stage): the blocks copy from `data` into their region and write its sum
// to `out` [blocks].
int bulk_copies(int direction, const void* data, const int32_t* dst_rows,
                const int32_t* smem_rows, void* target, int32_t* out, int copy_bytes, int wave,
                int waves, int group, int region_bytes, int blocks, void* stream) {
  if (copy_bytes <= 0 || copy_bytes % 16 || region_bytes % 16 || wave <= 0 ||
      wave > kMaxWave || waves < 0 || group <= 0 || blocks <= 0 ||
      (direction == kStage && (long long)group * copy_bytes > bulk::kMaxTxBytes))
    return int(cudaErrorInvalidValue);
  const Copies c{dst_rows, smem_rows, copy_bytes, wave, waves, group, region_bytes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (direction == kScatter) {
    err = cudaFuncSetAttribute(scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               region_bytes);
    if (err != cudaSuccess) return int(err);
    scatter_kernel<<<blocks, kThreads, region_bytes, s>>>(c, static_cast<const int4*>(data),
                                                          static_cast<uint8_t*>(target));
  } else if (direction == kStage) {
    err = cudaFuncSetAttribute(stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               region_bytes);
    if (err != cudaSuccess) return int(err);
    stage_kernel<<<blocks, kThreads, region_bytes, s>>>(c, static_cast<const uint8_t*>(data), out);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

const char* bulk_copies_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
