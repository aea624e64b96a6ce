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
//   table    the same offsets, read from an int32 table; as the TPU held it
//            in SMEM, a block stages its share of it in shared memory
//   nested   stage c reads the 7 planes' chunk c into 7 slots of one of 2
//            buffers, one mbarrier per buffer; stage c + 1 is issued before
//            stage c is waited for
//
// Where the TPU ran the ring on its one core, block i of a grid (one per SM
// by default) takes the units (stages for nested) u = i (mod grid), in
// order, `passes` times, and every thread adds the words it reads into a
// wrapping sum, so the data is used and the result checkable: one int32
// sum per block.
//
// What bounds it: device-memory bandwidth (data sheet: 3.35 TB/s), if
// enough bytes are in flight. At about a microsecond from issue to landing
// the card needs some 3-4 MB in flight, 25-30 KB per SM. The TPU's ring of
// 4 slots kept 16 KB per SM at 4 KB chunks, and its copy of a block barrier
// per chunk (and, for the table, a device-memory load of the next offset in
// front of each copy) held 4 KB reads to 28-51% of the bound on an H100.
// The ring kernel here is sized by bytes instead: a block keeps
// ring_slots(chunk, blocks per SM) slots, kRingBytes per SM, at least
// kMinSlots, divided between its blocks (at one block per SM: 16 slots of
// 4 KB, 4 of 16 KB, 4 of 48 KB; 128 and 192 KB per SM read slower), and
// runs it as a pipeline of full and empty barriers per slot with no block
// barrier in the loop: one producer lane waits for a slot's "empty"
// barrier and issues its copy; kConsumerWarps warps wait for its "full"
// barrier, add the slot into their sums and arrive on "empty". On an H100
// the one producer issues a 4 KB copy about every 170 ns, so the work
// between its copies is kept short: the table variant's share is loaded
// into shared memory once, before the loop, so no device-memory round trip
// sits in front of a copy, and the strided variant steps its stream and
// chunk without a division.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);  // warp 0 issues the copies
constexpr int kNestedThreads = 256;
constexpr int kRingBytes = 64 * 1024;  // bytes in flight per SM, split between its blocks
constexpr int kMinSlots = 4;  // slots per SM at least, whatever the chunk
constexpr int kMaxSlots = 64;
constexpr int kMaxPlanes = 7;
constexpr int kRowBytes = 512;
// Opt-in shared memory of a block, less the ring kernel's static barriers
// and block_sum's 32 words.
constexpr int kMaxDynamicShared = 232448 - 2 * kMaxSlots * 8 - 32 * 4;

enum Variant { kSeq = 0, kStrided = 1, kTable = 2, kNested = 3 };

struct Source {
  const uint8_t* rows;    // [rows][512 bytes]
  const int32_t* table;   // unit -> first row (kTable)
  long long plane_rows;   // stream pitch
  int chunk_rows;
  int streams;
};

// Slots of a block's ring: kRingBytes per SM in chunks, at least kMinSlots,
// split between the SM's blocks; at least 1 and at most kMaxSlots a block
// (kernels/bulk_read.py ring_slots).
__host__ __device__ int ring_slots(int chunk_rows, int blocks_per_sm) {
  int per_sm = kRingBytes / (chunk_rows * kRowBytes);
  per_sm = per_sm < kMinSlots ? kMinSlots : per_sm;
  const int slots = per_sm / blocks_per_sm;
  return slots < 1 ? 1 : slots > kMaxSlots ? kMaxSlots : slots;
}

// Wrapping sum of the 16-byte words first, first + stride, ... of a slot.
__device__ __forceinline__ uint32_t sum_slot(const uint8_t* slot, int bytes, int first, int stride) {
  const uint4* v = reinterpret_cast<const uint4*>(slot);
  uint32_t sum = 0;
  for (int i = first; i < bytes / 16; i += stride) {
    const uint4 x = v[i];
    sum += x.x + x.y + x.z + x.w;
  }
  return sum;
}

// seq, strided, table: a ring of `slots` slots with a full and an empty
// barrier each. Shared memory: the slots, then (table) the block's share of
// the table, entry k the first row of unit blockIdx.x + k gridDim.x.
template <int V>
__global__ void __launch_bounds__(kRingThreads)
    ring_kernel(Source s, int units, int passes, int slots, int32_t* out) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[kMaxSlots], empty[kMaxSlots];
  const int bytes = s.chunk_rows * kRowBytes;
  const int grid = gridDim.x;
  const int mine = units > int(blockIdx.x) ? (units - 1 - blockIdx.x) / grid + 1 : 0;
  const int total = mine * passes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* table = reinterpret_cast<int32_t*>(ring + slots * bytes);
  if constexpr (V == kTable) {
#pragma unroll 4
    for (int k = threadIdx.x; k < mine; k += kRingThreads) table[k] = s.table[blockIdx.x + k * grid];
  }
  if (threadIdx.x == 0) {
    for (int r = 0; r < slots; ++r) {
      bulk::init(&full[r], 1);
      bulk::init(&empty[r], kConsumerWarps);
    }
  }
  __syncthreads();
  uint32_t sum = 0;
  if (warp == 0) {
    if (lane == 0) {
      // Unit t goes to slot t mod slots; its copy waits for the slot's
      // previous unit to be read (parity 1 passes at once: the ring starts
      // empty). The next unit's first row is found before that wait, so a
      // table entry's shared-memory load overlaps it.
      // strided: unit u = blockIdx.x + c grid is chunk q of stream j (u = q
      // streams + j), stepped by grid without a division.
      const int j0 = blockIdx.x % s.streams, q0 = blockIdx.x / s.streams;
      const int dj = grid % s.streams, dq = grid / s.streams;
      int r = 0, c = 0, j = j0, q = q0;
      uint32_t parity = 1;
      auto first_row = [&]() -> long long {
        if constexpr (V == kSeq) {
          return (long long)(blockIdx.x + c * grid) * s.chunk_rows;
        } else if constexpr (V == kStrided) {
          return j * s.plane_rows + (long long)q * s.chunk_rows;
        } else {
          return table[c];
        }
      };
      long long row = total > 0 ? first_row() : 0;
      for (int t = 0; t < total; ++t) {
        bulk::wait(&empty[r], parity);
        bulk::arrive_expect_tx(&full[r], bytes);
        bulk::load(ring + r * bytes, s.rows + row * kRowBytes, bytes, &full[r]);
        if (++c == mine) {
          c = 0, j = j0, q = q0;
        } else if ((j += dj, q += dq, j >= s.streams)) {
          j -= s.streams, ++q;
        }
        row = first_row();
        if (++r == slots) r = 0, parity ^= 1;
      }
    }
    __syncwarp();
  } else {
    const int first = threadIdx.x - 32, stride = 32 * kConsumerWarps;
    int r = 0;
    uint32_t parity = 0;
    for (int t = 0; t < total; ++t) {
      bulk::wait(&full[r], parity);
      sum += sum_slot(ring + r * bytes, bytes, first, stride);
      __syncwarp();
      if (lane == 0) bulk::arrive(&empty[r]);
      if (++r == slots) r = 0, parity ^= 1;
    }
  }
  sum = bulk::block_sum(sum);
  if (threadIdx.x == 0) out[blockIdx.x] = int32_t(sum);
}

// nested: 2 buffers of `streams` slots; stage c reads chunk c of every plane.
__global__ void __launch_bounds__(kNestedThreads)
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
    sum += sum_slot(slots + buf * s.streams * bytes, s.streams * bytes, threadIdx.x, kNestedThreads);
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

int bulk_read_slots(int chunk_rows, int blocks_per_sm) {
  return chunk_rows > 0 && blocks_per_sm > 0 ? ring_slots(chunk_rows, blocks_per_sm) : 0;
}

// Per-block wrapping sums of `passes` passes over the units of `variant`
// (0 seq, 1 strided, 2 table, 3 nested) on `blocks` blocks: `src` rows of
// 512 bytes, `table` the units' first rows (variant 2), `out` [blocks]
// int32. `units` counts copies (for nested, stages x streams). A ring
// variant's slots follow from the blocks per SM; a ring and table share
// that do not fit a block's shared memory are refused.
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
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const int slots = ring_slots(chunk_rows, (blocks + sms - 1) / sms);
  long long shared = (long long)bytes * (nested ? 2 * streams : slots);
  if (variant == kTable) shared += ((units + blocks - 1) / blocks * 4LL + 15) / 16 * 16;
  if (shared > kMaxDynamicShared) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shared));
  if (err != cudaSuccess) return int(err);
  const Source s{static_cast<const uint8_t*>(src), table, plane_rows, chunk_rows, streams};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kSeq:
      ring_kernel<kSeq><<<blocks, kRingThreads, shared, st>>>(s, units, passes, slots, out);
      break;
    case kStrided:
      ring_kernel<kStrided><<<blocks, kRingThreads, shared, st>>>(s, units, passes, slots, out);
      break;
    case kTable:
      ring_kernel<kTable><<<blocks, kRingThreads, shared, st>>>(s, units, passes, slots, out);
      break;
    default: nested_kernel<<<blocks, kNestedThreads, shared, st>>>(s, units, passes, out); break;
  }
  return int(cudaGetLastError());
}

const char* bulk_read_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
