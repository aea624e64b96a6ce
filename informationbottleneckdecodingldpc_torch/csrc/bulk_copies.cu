// P4: the cost of one bulk copy and of one wait for copies to complete, on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU probe of the JAX reference's
// scripts/dma_probe.py: build (waves of 512 dynamic DMAs, scatter VMEM -> HBM
// at offsets from an SMEM table, or stage HBM -> VMEM) and build_tiny_loops
// (the same waves issued and waited for in loops of a few entries each).
// Here a copy is one cp.async.bulk, and the tables (kernels/bulk_copies.py
// copy_tables) give each copy its device-memory row (a random permutation of
// slots max(L, 4 KB) apart, so no two copies of a wave touch the same bytes)
// and its shared-memory row in a 192 KB region (copy k at slot k mod
// slots; dealt over blocks, the k-th copy of a block's share).
//
// The TPU probe issues its wave from the chip's one TensorCore, which is the
// whole chip. Its counterpart here is the card: a wave of `copies` copies is
// dealt over the grid, copy k to block k mod gridDim.x (one block per SM for
// the card-wide wave; one block alone measures one SM's issue cost), and
// inside a block over its 8 warps, each of whose lane 0 issues its
// copies and waits for them on its own:
//
//   scatter  shared -> global: the block loads the image rows its share
//            reads (a bulk copy a slot, issued before the tables load), then
//            warp w issues share positions w, w + 8, ... in
//            bulk groups of its own (bulk groups belong to the issuing
//            thread), one commit_group and wait_group per `group` copies;
//   stage    global -> shared: a region slot is owned by warp slot mod 8,
//            which issues every copy of the share into it, in order;
//            a group of at most `group` copies goes on one phase of the
//            warp's own mbarrier (arrive.expect_tx of their bytes) and is
//            waited for before the next. A group also ends before a second
//            copy into one slot, since two copies in flight into a slot
//            leave it undefined (the TPU probe let 4 race into a slot, as it
//            only timed them). At the end every thread acquires each warp's
//            last phase and adds up the region, zeroed at the start: one
//            int32 sum per block.
//
// A block waits for its whole share of a wave (a barrier after every warp's
// last wait) before it starts the next wave.
//
// What bounds it: at small L the issue of a copy (table reads, address
// arithmetic, the copy instruction) and the round trip of a wait, which the
// card-wide wave spreads over 132 SMs x 8 issuers; at large L device-memory
// bandwidth (3.35 TB/s on the data sheet), which one SM's copy engine cannot
// reach alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 512;
constexpr int kMaxShare = 512;  // copies of one block in a wave
constexpr int kMaxSlots = 64;   // region slots, one bit each

enum Direction { kScatter = 0, kStage = 1 };

struct Copies {
  const int32_t* dst_rows;   // [copies] device-memory rows
  const int32_t* smem_rows;  // [share] region rows by share position, multiples of `spacing`
  int copy_bytes;
  int copies;   // per wave, dealt over the grid
  int waves;
  int group;    // copies per wait
  int spacing;  // rows of a region slot
  int region_bytes;
  // The slots a share uses, one bit each, for a share of ceil(copies /
  // grid) copies and for one of floor(copies / grid): the scatter's image
  // loads.
  unsigned long long need_long, need_short;
};

// Loads the block's share of the tables into shared memory: copies b,
// b + grid, ... and the region rows of its positions; returns its length.
__device__ __forceinline__ int load_share(const Copies& c, int32_t* dst, int32_t* row) {
  const int b = blockIdx.x, blocks = gridDim.x;
  const int share = b < c.copies ? (c.copies - 1 - b) / blocks + 1 : 0;
  for (int i = threadIdx.x; i < share; i += kThreads) {
    dst[i] = c.dst_rows[b + i * blocks];
    row[i] = c.smem_rows[i];
  }
  return share;
}

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(Copies c, const uint8_t* image, uint8_t* target) {
  extern __shared__ __align__(128) uint8_t region[];
  __shared__ int32_t dst[kMaxShare], row[kMaxShare];
  __shared__ uint64_t bar;
  // The image rows the share reads, one bulk copy a slot on one phase, issued
  // first: the slots depend on the share's length alone.
  const int b = blockIdx.x, blocks = gridDim.x;
  const int share = b < c.copies ? (c.copies - 1 - b) / blocks + 1 : 0;
  const unsigned long long slots =
      share == 0 ? 0ull : share == (c.copies + blocks - 1) / blocks ? c.need_long : c.need_short;
  if (threadIdx.x == 0) {
    bulk::init(&bar, 1);
    bulk::arrive_expect_tx(&bar, uint32_t(__popcll(slots)) * c.copy_bytes);
    const int slot_bytes = c.spacing * kRowBytes;
    for (int s = 0; s < kMaxSlots; ++s)
      if (slots >> s & 1)
        bulk::load(region + s * slot_bytes, image + s * slot_bytes, c.copy_bytes, &bar);
  }
  load_share(c, dst, row);
  __syncthreads();
  bulk::wait(&bar, 0);
  const int warp = threadIdx.x >> 5;
  const bool issues = (threadIdx.x & 31) == 0;
  for (int w = 0; w < c.waves; ++w) {
    if (issues) {
      int open = 0;
      for (int i = warp; i < share; i += kWarps) {
        bulk::store(target + (long long)dst[i] * kRowBytes, region + row[i] * kRowBytes,
                    c.copy_bytes);
        if (++open == c.group || i + kWarps >= share) {
          bulk::commit();
          bulk::wait_all();
          open = 0;
        }
      }
    }
    __syncthreads();  // the block's share of this wave is written
  }
}

__global__ void __launch_bounds__(kThreads)
    stage_kernel(Copies c, const uint8_t* source, int32_t* out) {
  extern __shared__ __align__(128) uint8_t region[];
  __shared__ int32_t dst[kMaxShare], row[kMaxShare];
  __shared__ int16_t owned[kWarps][kMaxShare];  // each warp's share positions, in order
  __shared__ uint64_t bars[kWarps];
  __shared__ int phases[kWarps];  // phases each warp's barrier completed
  const int share = load_share(c, dst, row);
  int4* r = reinterpret_cast<int4*>(region);
  for (int i = threadIdx.x; i < c.region_bytes / 16; i += kThreads) r[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < kWarps) bulk::init(&bars[threadIdx.x], 1);
  bulk::fence_proxy_async();  // the zeroing before the copies overwrite it
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The warp lists the positions whose slot it owns (slot mod 8), once.
  int mine = 0;
  for (int base = 0; base < share; base += 32) {
    const int i = base + lane;
    const bool own = i < share && row[i] / c.spacing % kWarps == warp;
    const unsigned ballot = __ballot_sync(0xffffffffu, own);
    if (own) owned[warp][mine + __popc(ballot & ((1u << lane) - 1))] = int16_t(i);
    mine += __popc(ballot);
  }
  __syncwarp();
  const int16_t* list = owned[warp];
  int done = 0;
  for (int w = 0; w < c.waves; ++w) {
    if (lane == 0) {
      for (int a = 0; a < mine;) {
        // The group: up to `group` of the warp's copies from its a-th,
        // ending before a second copy into one slot.
        unsigned long long open = 0;
        int b = a;
        while (b < mine && b - a < c.group) {
          const unsigned long long bit = 1ull << (row[list[b]] / c.spacing);
          if (open & bit) break;
          open |= bit;
          ++b;
        }
        bulk::arrive_expect_tx(&bars[warp], uint32_t(b - a) * c.copy_bytes);
        for (int k = a; k < b; ++k)
          bulk::load(region + row[list[k]] * kRowBytes,
                     source + (long long)dst[list[k]] * kRowBytes, c.copy_bytes, &bars[warp]);
        bulk::wait(&bars[warp], done & 1);
        ++done;
        a = b;
      }
    }
    __syncthreads();  // the block's share of this wave has landed
  }
  if (lane == 0) phases[warp] = done;
  __syncthreads();
  for (int v = 0; v < kWarps; ++v)  // every thread acquires each barrier's last phase
    if (phases[v] > 0) bulk::wait(&bars[v], (phases[v] - 1) & 1);
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

int bulk_copies_max_share() { return kMaxShare; }
int bulk_copies_max_slots() { return kMaxSlots; }
int bulk_copies_warps() { return kWarps; }

// `waves` waves of `copies` copies of `copy_bytes`, dealt over `blocks`
// blocks (copy k to block k mod blocks) and kWarps issuing warps a block,
// `group` copies per wait, on a region of `region_bytes` of shared memory a
// block. Direction 0 (scatter): the blocks load the rows of `data` (the
// image) their copies read (the slots `need_long` for a share of
// ceil(copies / blocks) copies, `need_short` for a shorter one) and copy
// them into `target`. Direction 1 (stage): the blocks copy from `data` into
// their region and write its sum to `out` [blocks].
int bulk_copies(int direction, const void* data, const int32_t* dst_rows,
                const int32_t* smem_rows, void* target, int32_t* out, int copy_bytes, int copies,
                int waves, int group, int spacing, int region_bytes, int blocks,
                unsigned long long need_long, unsigned long long need_short, void* stream) {
  if (copy_bytes <= 0 || copy_bytes % 16 || copy_bytes > spacing * kRowBytes ||
      region_bytes % 16 || region_bytes / (spacing * kRowBytes) > kMaxSlots || copies <= 0 ||
      waves < 0 || group <= 0 || blocks <= 0 || (copies + blocks - 1) / blocks > kMaxShare ||
      (direction == kStage && (long long)group * copy_bytes > bulk::kMaxTxBytes))
    return int(cudaErrorInvalidValue);
  const Copies c{dst_rows, smem_rows,    copy_bytes, copies,    waves,
                 group,    spacing,      region_bytes, need_long, need_short};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (direction == kScatter) {
    err = cudaFuncSetAttribute(scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               region_bytes);
    if (err != cudaSuccess) return int(err);
    scatter_kernel<<<blocks, kThreads, region_bytes, s>>>(c, static_cast<const uint8_t*>(data),
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
