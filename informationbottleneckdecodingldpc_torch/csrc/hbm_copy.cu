// K6: device-memory copy bandwidth on Hopper (sm_90a), for the roofline's
// traffic bounds (K3 and K4 keep their message views in device memory),
// which divide by the faster of this copy and torch's copy_.
//
// Replaces the Pallas TPU kernel of the JAX reference's
// scripts/bench_matrix.py:measure_hbm_bandwidth, which streams 2 MB chunks
// HBM -> VMEM -> HBM through a depth-4 ring. Here too the bytes pass through
// a ring in shared memory, moved by the Tensor Memory Accelerator's bulk
// copies (bulk.cuh) rather than by threads. A persistent grid of one block
// per SM splits `src` into kChunk chunks, chunk k to block k % grid, so at
// any time the grid reads and writes one window of neighbouring chunks. Per
// block one thread keeps kStages - 1 global -> shared copies in flight on
// the stages' mbarriers; as each stage lands it issues the shared -> global
// copy of it in a bulk group, then refills the stage that the previous store
// has finished reading. `passes` passes run in one launch as one stream of
// chunks. The bytes past the last whole chunk (fewer than kChunk, any count)
// are copied by the other threads of the last block. The buffers are 256 MB
// each, five times the 50 MB L2, so every pass goes to device memory. Read
// and write bytes both count, as the TPU kernel counted them.
//
// What bounds it: device-memory bandwidth alone (data sheet: 3.35 TB/s for
// the H100 SXM; 0.1603 ms per 256 MB pass, read and write). The previous
// design moved 16-byte vectors through registers, every thread in a
// grid-stride loop, and ran 5-6% behind copy_ (0.1892 against 0.1789 ms on
// an NVIDIA H100 80GB HBM3 at 700 W). A bulk copy keeps a whole chunk in
// flight for one instruction and spends no registers on it. The ring's
// shape, 8 stages of 16 KB, and the interleaved chunks are constants picked
// on the card from rings of 4-16 stages of 8-64 KB, one or two blocks per
// SM, contiguous spans or interleaved chunks, a refill lag of one or two
// stores and an L2 evict-first hint: interleaving gained more than any ring
// shape, the hint nothing. It still runs behind
// copy_: 0.1890 against 0.1798 ms a pass, 2881.7 against 2983.4 GB/s
// differenced (same card; chip_smoke.py phases 17-18), 0.8% faster than
// the previous design.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"

namespace {

constexpr int kStages = 8;
constexpr uint32_t kChunk = 16 * 1024;
constexpr int kThreads = 128;  // thread 0 issues the copies; warps 1-3 copy the tail

__global__ void __launch_bounds__(kThreads)
    hbm_copy_kernel(const unsigned char* src, unsigned char* dst, long long nbytes, int passes) {
  extern __shared__ __align__(128) unsigned char ring[];  // [kStages][kChunk]
  __shared__ uint64_t full[kStages];
  const long long chunks = nbytes / kChunk;
  // This block's chunks: blockIdx.x + k * gridDim.x for k < mine, in every
  // pass; hbm_copy.py:copy_spans mirrors it.
  const long long mine =
      blockIdx.x < chunks ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0 && mine > 0) {
    for (int s = 0; s < kStages; ++s) bulk::init(&full[s], 1);
    const long long total = mine * passes;  // chunk j of the stream
    const auto offset = [&](long long j) {
      return (blockIdx.x + j % mine * gridDim.x) * kChunk;
    };
    const auto load = [&](long long j) {
      const int s = int(j % kStages);
      bulk::arrive_expect_tx(&full[s], kChunk);
      bulk::load(ring + s * kChunk, src + offset(j), kChunk, &full[s]);
    };
    for (long long j = 0; j < kStages && j < total; ++j) load(j);
    for (long long j = 0; j < total; ++j) {
      const int s = int(j % kStages);
      bulk::wait(&full[s], uint32_t(j / kStages) & 1);
      bulk::store(dst + offset(j), ring + s * kChunk, kChunk);
      bulk::commit();
      // Refill the stage of chunk j-1 once its store has read it, so one
      // store and kStages - 1 loads stay in flight.
      if (j >= 1 && j - 1 + kStages < total) {
        bulk::wait_read<1>();
        load(j - 1 + kStages);
      }
    }
    bulk::wait_all();
  }
  // The tail [chunks * kChunk, nbytes): 16-byte vectors, then single bytes.
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x >= 32) {
    const long long first = threadIdx.x - 32, step = blockDim.x - 32;
    const long long v0 = chunks * kChunk / 16, v1 = nbytes / 16;
    const int4* s16 = reinterpret_cast<const int4*>(src);
    int4* d16 = reinterpret_cast<int4*>(dst);
    for (int p = 0; p < passes; ++p) {
      for (long long i = v0 + first; i < v1; i += step) d16[i] = s16[i];
      for (long long i = v1 * 16 + first; i < nbytes; i += step) dst[i] = src[i];
    }
  }
}

}  // namespace

extern "C" {

// Copies `nbytes` bytes from `src` to `dst` (both 16-byte aligned), `passes`
// times, on `stream`, with one block on every SM.
int hbm_copy(const void* src, void* dst, long long nbytes, int passes, void* stream) {
  constexpr int smem = kStages * kChunk;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hbm_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  hbm_copy_kernel<<<sms, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nbytes, passes);
  return int(cudaGetLastError());
}

// The chunk, which hbm_copy.py's schedule mirrors.
int hbm_copy_chunk_bytes() { return int(kChunk); }

const char* hbm_copy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
