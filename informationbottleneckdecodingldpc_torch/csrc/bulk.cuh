// Hopper (sm_90) asynchronous bulk copies and transaction barriers, for the
// kernels that stage device memory through shared memory with the Tensor
// Memory Accelerator's non-tensor form, cp.async.bulk: the read probes
// (bulk_read.cu), the per-copy cost probes (bulk_copies.cu), the stage
// skeleton (stage_chunks.cu) and the device-memory copy K6 (hbm_copy.cu).
//
// A global -> shared copy is issued by one thread and completes on an
// mbarrier in shared memory: the issuing thread first adds the bytes it
// expects with arrive_expect_tx (which also counts its arrival), and the
// barrier's phase flips once every expected byte has landed. A barrier
// counts at most 2^20 - 1 pending transaction bytes. A ring of slots pairs
// each slot's transaction barrier ("full") with one its readers arrive on
// ("empty", arrive()), which the issuing thread waits for before it loads
// the slot again. A shared -> global copy
// completes in a bulk group: commit() closes the group of copies issued
// since the last one, and wait_all() returns once every committed group has
// been written. Generic stores to shared memory that a bulk copy will read
// need fence_proxy_async() by the writing threads before the barrier that
// orders them with the issuing thread. Addresses and sizes are multiples of
// 16 bytes.

#pragma once

#include <cstdint>

namespace bulk {

constexpr uint32_t kMaxTxBytes = (1u << 20) - 1;  // an mbarrier's transaction count

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises the barrier for `count` arrivals per phase, then
// fences the initialisation before any thread or copy uses it.
__device__ __forceinline__ void init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and expect `bytes` more transaction bytes in this phase.
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive once, without transaction bytes.
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed. A barrier starts in
// phase 0, so a wait on parity 1 passes at once (a slot that starts empty).
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` from global `src` to shared `dst`; completes on `bar`.
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Copy `bytes` from shared `src` to global `dst`, in the open bulk group.
__device__ __forceinline__ void store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until every committed bulk group has been written to global memory.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Wait until at most N of the committed bulk groups are still reading their
// shared-memory sources: the sources of the others may be written again.
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Wrapping sum of a block's per-thread values; every thread gets it. Uses
// 32 words of shared memory and two barriers.
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  uint32_t total = 0;
  for (int w = 0; w < int(blockDim.x + 31) / 32; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

}  // namespace bulk
