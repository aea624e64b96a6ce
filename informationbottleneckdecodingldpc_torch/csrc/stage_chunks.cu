// P5: the staged 7-plane skeleton of a simulated decode iteration on Hopper
// (sm_90a): per chunk, 7 planes copied from device memory into shared memory
// by bulk copies and drained before the next.
//
// Replaces the Pallas TPU probe of the JAX reference's
// scripts/stage_probe.py:build, which stages 7 planes of 2048 rows (512 B
// each) per chunk, 40 chunks per iteration (293.6 MB), with an in-loop start
// and wait. A block has 227 KB, not the TPU chunk's 7 MB, so chunk c is cut
// into piece-chunks (c, p) of `piece_rows` rows, numbered u = c (2048 /
// piece_rows) + p: 7 bulk copies, plane j's from row base_j + u piece_rows.
// Block i of the grid takes u = i (mod grid) in order, every iteration.
// Variants (kernels/stage_chunks.py stage_schedule has the TPU's order):
//
//   base      one mbarrier: issue 7, wait, per piece-chunk (also 'unalign',
//             whose plane bases are j 1237 + 3 rows off the others: every row
//             is 512 B, so each base stays 512 B aligned here and only the
//             addresses move)
//   dynsem    one mbarrier per buffer half, alternating, no prefetch
//   pipeline  the TPU K3's double buffer: piece-chunk 0 staged at the start
//             of every iteration, the next issued into the other half before
//             the current one is waited for, then threads write S_in + 1 into
//             that half of S_out
//   vwrite    stage, wait, threads write S_in + 1 into S_out
//
// After each wait every thread adds its share of the staged words (and of
// what it wrote to S_out) into a wrapping sum, so the data is used and the
// result checkable: one int32 per block.
//
// What bounds it: device-memory bandwidth (data sheet: 3.35 TB/s; 293.6 MB
// per iteration, 0.0876 ms). A piece of 32 rows keeps 7 x 16 KB in flight
// per SM, 16 rows 7 x 8 KB, which the bulk-read probes found enough for
// 93-94% of it; but every piece-chunk here drains before the next is issued
// (except in pipeline), so each pays a full copy latency.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 7;
constexpr int kRowBytes = 512;

enum Variant { kBase = 0, kDynsem = 1, kPipeline = 2, kVwrite = 3 };

struct Geometry {
  const uint8_t* src;  // [rows][512 bytes]
  long long base[kMaxPlanes];  // first row of each plane
  int planes, piece_rows, units;
};

template <int V>
__global__ void __launch_bounds__(kThreads) stage_kernel(Geometry g, int iters, int32_t* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bars[2];
  constexpr bool kWrites = V == kPipeline || V == kVwrite;
  constexpr int kHalves = V == kPipeline ? 2 : 1;
  const int copy = g.piece_rows * kRowBytes;  // one plane of a piece-chunk
  const int stage = g.planes * copy;
  uint8_t* s_in = smem;                     // [kHalves][planes][copy]
  uint8_t* s_out = smem + kHalves * stage;  // the same, for the writing variants
  const int mine = g.units > int(blockIdx.x) ? (g.units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    bulk::init(&bars[0], 1);
    bulk::init(&bars[1], 1);
  }
  __syncthreads();
  // Thread 0 stages the block's t-th piece-chunk into half h on barrier b.
  auto issue = [&](int t, int h, int b) {
    const long long row = (long long)(blockIdx.x + t * gridDim.x) * g.piece_rows;
    bulk::arrive_expect_tx(&bars[b], stage);
    for (int j = 0; j < g.planes; ++j)
      bulk::load(s_in + h * stage + j * copy, g.src + (g.base[j] + row) * kRowBytes, copy, &bars[b]);
  };
  uint32_t sum = 0, parity = 0;  // bit b: the parity of barrier b's next phase
  for (int it = 0; it < iters; ++it) {
    if (V == kPipeline && threadIdx.x == 0 && mine > 0) issue(0, 0, 0);
    for (int t = 0; t < mine; ++t) {
      const int h = kHalves == 2 ? t & 1 : 0;
      const int b = V == kBase || V == kVwrite ? 0 : t & 1;
      if (threadIdx.x == 0) {
        if (V != kPipeline) issue(t, h, b);
        else if (t + 1 < mine) issue(t + 1, h ^ 1, b ^ 1);
      }
      bulk::wait(&bars[b], (parity >> b) & 1);
      parity ^= 1u << b;
      const uint4* in = reinterpret_cast<const uint4*>(s_in + h * stage);
      uint4* o = reinterpret_cast<uint4*>(s_out + h * stage);
      for (int i = threadIdx.x; i < stage / 16; i += kThreads) {
        const uint4 x = in[i];
        sum += x.x + x.y + x.z + x.w;
        if (kWrites) {
          const uint4 y = make_uint4(x.x + 1, x.y + 1, x.z + 1, x.w + 1);
          o[i] = y;
          sum += y.x + y.y + y.z + y.w;
        }
      }
      // Every thread is done with half h before it is staged into again.
      __syncthreads();
    }
  }
  sum = bulk::block_sum(sum);
  if (threadIdx.x == 0) out[blockIdx.x] = int32_t(sum);
}

const void* kernel_of(int variant) {
  switch (variant) {
    case kBase: return reinterpret_cast<const void*>(stage_kernel<kBase>);
    case kDynsem: return reinterpret_cast<const void*>(stage_kernel<kDynsem>);
    case kPipeline: return reinterpret_cast<const void*>(stage_kernel<kPipeline>);
    case kVwrite: return reinterpret_cast<const void*>(stage_kernel<kVwrite>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int stage_chunks_max_planes() { return kMaxPlanes; }

// Per-block wrapping sums of `iters` iterations of `variant` (0 base or
// unalign, 1 dynsem, 2 pipeline, 3 vwrite) on `blocks` blocks: `src` rows of
// 512 bytes, `bases` the `planes` planes' first rows (host array), `units`
// piece-chunks of `piece_rows` rows per iteration, `out` [blocks] int32.
int stage_chunks(int variant, const void* src, const long long* bases, int planes,
                 int piece_rows, int units, int iters, int blocks, int32_t* out, void* stream) {
  const void* kernel = kernel_of(variant);
  if (kernel == nullptr || planes < 1 || planes > kMaxPlanes || piece_rows < 1 || units < 0 ||
      iters < 0 || blocks < 1)
    return int(cudaErrorInvalidValue);
  const long long stage = (long long)planes * piece_rows * kRowBytes;
  if (stage > bulk::kMaxTxBytes) return int(cudaErrorInvalidValue);  // one barrier's phase
  const int halves = variant == kPipeline ? 2 : 1;
  const int writes = variant == kPipeline || variant == kVwrite ? 2 : 1;
  const int shared = int(stage * halves * writes);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return int(err);
  Geometry g{static_cast<const uint8_t*>(src), {}, planes, piece_rows, units};
  for (int j = 0; j < planes; ++j) g.base[j] = bases[j];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: stage_kernel<kBase><<<blocks, kThreads, shared, s>>>(g, iters, out); break;
    case kDynsem: stage_kernel<kDynsem><<<blocks, kThreads, shared, s>>>(g, iters, out); break;
    case kPipeline: stage_kernel<kPipeline><<<blocks, kThreads, shared, s>>>(g, iters, out); break;
    default: stage_kernel<kVwrite><<<blocks, kThreads, shared, s>>>(g, iters, out); break;
  }
  return int(cudaGetLastError());
}

const char* stage_chunks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
