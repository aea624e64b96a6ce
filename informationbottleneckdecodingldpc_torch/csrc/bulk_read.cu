// P2/P3: device-memory read bandwidth through bulk copies into shared
// memory, by chunk size and stream layout, on Hopper (sm_90a).
//
// Replaces the Pallas TPU probes of the JAX reference's
// scripts/read_bw_probe.py:build (HBM -> VMEM reads through a depth-4 ring
// of slots, one sequential stream or 7 interleaved streams) and
// scripts/read_bw_probe2.py:build (the same with the unit offsets read from
// an SMEM table, and a nested form: 2 stages of 7 planes, double-buffered).
// The unit is the TPU's 512-byte row; a chunk is `chunk_rows` rows. The
// schedule (kernels/bulk_read.py read_schedule) lists the units in order:
//
//   seq      unit u reads rows [u L, u L + L)
//   strided  7 streams `plane` rows apart: c = u / 7, j = u % 7, rows from
//            j plane + c L (the DVB-S2 check-node plane pattern)
//   table    the same offsets, read from an int32 table in device memory
//            (the TPU's SMEM table; here the issuing thread loads its own)
//   nested   stage c reads the 7 planes' chunk c into 7 slots of one of 2
//            buffers, one mbarrier per buffer; stage c + 1 is issued before
//            stage c is waited for
//
// Where the TPU ran the ring on its one core, block i of a grid (one per SM
// by default) takes the units (stages for nested) u = i (mod grid), in
// order, `passes` times. Thread 0 keeps up to kRing bulk copies in flight,
// one slot and one mbarrier each; after each wait every thread adds its
// share of the staged words into a wrapping sum, so the data is used and
// the result checkable: one int32 sum per block.
//
// What bounds it: device-memory bandwidth (data sheet: 3.35 TB/s), if
// enough bytes are in flight: a block has kRing chunks (or 2 x 7 for
// nested) outstanding, so at 4 KB chunks 132 SMs keep about 2 MB in flight,
// which at about a microsecond of latency is under what 3.35 TB/s needs;
// 16 KB and 48 KB chunks keep 8 and 25 MB. The sum of a slot (256 threads,
// 16-byte shared loads) is short next to a chunk's transfer.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 4;
constexpr int kMaxPlanes = 7;
constexpr int kRowBytes = 512;

enum Variant { kSeq = 0, kStrided = 1, kTable = 2, kNested = 3 };

struct Source {
  const uint8_t* rows;    // [rows][512 bytes]
  const int32_t* table;   // unit -> first row (kTable)
  long long plane_rows;   // stream pitch
  int chunk_rows;
  int streams;
};

template <int V>
__device__ __forceinline__ const uint8_t* unit_src(const Source& s, int u) {
  long long row;
  if constexpr (V == kSeq) {
    row = (long long)u * s.chunk_rows;
  } else if constexpr (V == kStrided) {
    const int c = u / s.streams, j = u - c * s.streams;
    row = j * s.plane_rows + (long long)c * s.chunk_rows;
  } else {
    row = s.table[u];
  }
  return s.rows + row * kRowBytes;
}

__device__ __forceinline__ uint32_t sum_slot(const uint8_t* slot, int bytes) {
  const uint4* v = reinterpret_cast<const uint4*>(slot);
  uint32_t sum = 0;
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) {
    const uint4 x = v[i];
    sum += x.x + x.y + x.z + x.w;
  }
  return sum;
}

// seq, strided, table: a ring of kRing slots.
template <int V>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(Source s, int units, int passes, int32_t* out) {
  extern __shared__ __align__(128) uint8_t slots[];
  __shared__ uint64_t bars[kRing];
  const int bytes = s.chunk_rows * kRowBytes;
  const int mine = units > int(blockIdx.x) ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * passes;
  if (threadIdx.x == 0) {
    for (int r = 0; r < kRing; ++r) bulk::init(&bars[r], 1);
  }
  __syncthreads();
  auto unit = [&](int t) { return int(blockIdx.x) + (t % mine) * int(gridDim.x); };
  if (threadIdx.x == 0) {
    for (int t = 0; t < kRing && t < total; ++t) {
      bulk::arrive_expect_tx(&bars[t], bytes);
      bulk::load(slots + t * bytes, unit_src<V>(s, unit(t)), bytes, &bars[t]);
    }
  }
  uint32_t sum = 0;
  for (int t = 0; t < total; ++t) {
    const int r = t % kRing;
    // The next unit's address is read before the wait, so a table load
    // overlaps it.
    const uint8_t* next = nullptr;
    if (threadIdx.x == 0 && t + kRing < total) next = unit_src<V>(s, unit(t + kRing));
    bulk::wait(&bars[r], (t / kRing) & 1);
    sum += sum_slot(slots + r * bytes, bytes);
    __syncthreads();
    if (next != nullptr) {
      bulk::arrive_expect_tx(&bars[r], bytes);
      bulk::load(slots + r * bytes, next, bytes, &bars[r]);
    }
  }
  sum = bulk::block_sum(sum);
  if (threadIdx.x == 0) out[blockIdx.x] = int32_t(sum);
}

// nested: 2 buffers of `streams` slots; stage c reads chunk c of every plane.
__global__ void __launch_bounds__(kThreads)
    nested_kernel(Source s, int units, int passes, int32_t* out) {
  extern __shared__ __align__(128) uint8_t slots[];
  __shared__ uint64_t bars[2];
  const int bytes = s.chunk_rows * kRowBytes;
  const int stages = units / s.streams;
  const int mine = stages > int(blockIdx.x) ? (stages - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * passes;
  if (threadIdx.x == 0) {
    bulk::init(&bars[0], 1);
    bulk::init(&bars[1], 1);
  }
  __syncthreads();
  auto issue = [&](int t) {
    const long long c = int(blockIdx.x) + (t % mine) * int(gridDim.x);
    const int buf = t & 1;
    bulk::arrive_expect_tx(&bars[buf], s.streams * bytes);
    for (int j = 0; j < s.streams; ++j) {
      const uint8_t* src = s.rows + (j * s.plane_rows + c * s.chunk_rows) * kRowBytes;
      bulk::load(slots + (buf * s.streams + j) * bytes, src, bytes, &bars[buf]);
    }
  };
  if (threadIdx.x == 0 && total > 0) issue(0);
  uint32_t sum = 0;
  for (int t = 0; t < total; ++t) {
    // The other buffer was released by the barrier that ended stage t - 1.
    if (threadIdx.x == 0 && t + 1 < total) issue(t + 1);
    const int buf = t & 1;
    bulk::wait(&bars[buf], (t >> 1) & 1);
    sum += sum_slot(slots + buf * s.streams * bytes, s.streams * bytes);
    __syncthreads();
  }
  sum = bulk::block_sum(sum);
  if (threadIdx.x == 0) out[blockIdx.x] = int32_t(sum);
}

const void* kernel_of(int variant) {
  switch (variant) {
    case kSeq: return reinterpret_cast<const void*>(ring_kernel<kSeq>);
    case kStrided: return reinterpret_cast<const void*>(ring_kernel<kStrided>);
    case kTable: return reinterpret_cast<const void*>(ring_kernel<kTable>);
    case kNested: return reinterpret_cast<const void*>(nested_kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int bulk_read_ring() { return kRing; }

// Per-block wrapping sums of `passes` passes over the units of `variant`
// (0 seq, 1 strided, 2 table, 3 nested) on `blocks` blocks: `src` rows of
// 512 bytes, `table` the units' first rows (variant 2), `out` [blocks]
// int32. `units` counts copies (for nested, stages x streams).
int bulk_read(int variant, const void* src, const int32_t* table, int32_t* out,
              long long plane_rows, int chunk_rows, int streams, int units, int passes, int blocks,
              void* stream) {
  const void* kernel = kernel_of(variant);
  const int bytes = chunk_rows * kRowBytes;
  const bool nested = variant == kNested;
  if (kernel == nullptr || chunk_rows <= 0 || blocks <= 0 || units < 0 || passes < 0 ||
      streams < 1 || (nested && (streams > kMaxPlanes || units % streams)) ||
      (variant == kTable && table == nullptr))
    return int(cudaErrorInvalidValue);
  if ((long long)bytes * (nested ? streams : 1) > bulk::kMaxTxBytes)  // one barrier's phase
    return int(cudaErrorInvalidValue);
  const int shared = bytes * (nested ? 2 * streams : kRing);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return int(err);
  const Source s{static_cast<const uint8_t*>(src), table, plane_rows, chunk_rows, streams};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kSeq: ring_kernel<kSeq><<<blocks, kThreads, shared, st>>>(s, units, passes, out); break;
    case kStrided:
      ring_kernel<kStrided><<<blocks, kThreads, shared, st>>>(s, units, passes, out);
      break;
    case kTable: ring_kernel<kTable><<<blocks, kThreads, shared, st>>>(s, units, passes, out); break;
    default: nested_kernel<<<blocks, kThreads, shared, st>>>(s, units, passes, out); break;
  }
  return int(cudaGetLastError());
}

const char* bulk_read_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
