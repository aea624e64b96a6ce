// K5: peak rates of the decoders' primitives on Hopper (sm_90a), for the
// roofline of the benchmark matrix.
//
// Replaces the Pallas TPU microkernels of informationbottleneckdecodingldpc_tpu/
// utils/peaks.py: measure_extract_peak (K5a), measure_column_peak (K5b) and
// _measure_float_binop (K5c). Those time the TPU's packed-LUT primitives
// (field extracts, column builds); here each kernel times the primitive the
// Hopper decoders actually run:
//
//   K5a lookup1d: s = row[s] from a byte table of T entries in shared memory,
//     the 1-D remap match_row[out[k]] of ib_lut_groups.cuh (one ld.shared);
//   K5b lookup2d: a = lut(l, a, b) through ib_lut::Luts itself, with kSlots
//     LUT slots as a fold has; b is a second chain, b = lut(l', b, a), so both
//     indices are live values. The tables lie in shared memory as K1 holds
//     them, one copy per block, where random indices of a warp's lanes meet
//     in a bank (T = 32: 1 KB per slot over 32 banks);
//   K5b lookup2d_lanes: the same chains with a copy of the tables per lane,
//     interleaved so that lane l reads only bank l: no bank conflicts, at
//     the cost of 32 times the shared memory (128 KB at T = 32). The
//     roofline takes the faster of the two layouts as the pairwise-lookup
//     peak;
//   K5c float pairs: x = op(x, y); y = op(y, -x) with the device functions of
//     float_groups.cuh that K2 and K4 run: the min-sum op
//     sign(a) sign(b) min(|a|, |b|), boxplus, add + clip_llr, and fminf. The
//     negation keeps a compiler from folding min(y, min(x, y)) to min(x, y).
//
// Every thread runs kChains independent chains held in registers, kSteps
// unrolled applications per chain per loop iteration, and a runtime loop
// count. Tables and initial states come from device memory, so nothing is
// folded at compile time, and each thread writes the sum of its final states,
// so no chain is dead code. The caller launches enough blocks to fill every
// SM (peaks_blocks) and takes the rate from the difference of two loop
// counts, which cancels the launch overhead.
//
// What bounds them on this card: K5a/K5b issue one shared-memory load per
// lookup (plus the index arithmetic of K5b), so the load/store unit's issue
// rate and the shared-memory latency hidden by 16 chains x 64 warps per SM;
// K5c the FP32 and special-function pipes (boxplus: two expf and two log1pf
// per application). Device-memory traffic is a few bytes per thread.

#include <cuda_runtime.h>

#include <cstdint>

#include "float_groups.cuh"
#include "ib_lut_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 16;
constexpr int kSteps = 64;
constexpr int kSlots = 4;  // the LUT slots of a degree-6 check's fold
constexpr int kMaxT = 32;
constexpr int kLanesThreads = 1024;  // one block holds the per-lane copies

__global__ void __launch_bounds__(kThreads)
    lookup1d_kernel(const uint8_t* table, const int32_t* init, int32_t* out, int t, int loops) {
  __shared__ uint8_t row[kMaxT];
  for (int i = threadIdx.x; i < t; i += blockDim.x) row[i] = table[i];
  __syncthreads();
  const int n = gridDim.x * blockDim.x, tid = blockIdx.x * blockDim.x + threadIdx.x;
  int s[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) s[c] = init[c * n + tid];
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) s[c] = row[s[c]];
    }
  }
  int acc = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc += s[c];
  out[tid] = acc;
}

__global__ void __launch_bounds__(kThreads)
    lookup2d_kernel(const uint8_t* luts, const int32_t* init, int32_t* out, int t, int loops) {
  __shared__ uint8_t tab[kSlots * kMaxT * kMaxT];
  for (int i = threadIdx.x; i < kSlots * t * t; i += blockDim.x) tab[i] = luts[i];
  __syncthreads();
  const ib_lut::Luts lut{tab, t * t, t};
  const int n = gridDim.x * blockDim.x, tid = blockIdx.x * blockDim.x + threadIdx.x;
  int a[kChains], b[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    a[c] = init[c * n + tid];
    b[c] = init[(kChains + c) * n + tid];
  }
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < kSteps; k += 2) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        a[c] = lut(k % kSlots, a[c], b[c]);
        b[c] = lut((k + 1) % kSlots, b[c], a[c]);
      }
    }
  }
  int acc = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc += a[c] + b[c];
  out[tid] = acc;
}

// Lane l's copy of entry (a, b) of slot j lies in byte j of word
// (a t + b) 32 + l: t * t * 32 words of dynamic shared memory, each lane of
// each warp of the block reading its own bank. One multiply-add and one
// shift-add find a lookup's word; the slot is a constant byte offset.
__global__ void __launch_bounds__(kLanesThreads)
    lookup2d_lanes_kernel(const uint8_t* luts, const int32_t* init, int32_t* out, int t,
                          int loops) {
  static_assert(kSlots <= 4, "one byte of a word per slot");
  extern __shared__ uint8_t copies[];
  const int entries = t * t;
  for (int i = threadIdx.x; i < 128 * entries; i += blockDim.x)
    copies[i] = (i & 3) < kSlots ? luts[(i & 3) * entries + (i >> 7)] : 0;
  __syncthreads();
  const uint8_t* mine = copies + 4 * (threadIdx.x & 31);
  auto lut = [&](int slot, int a, int b) { return int(mine[((a * t + b) << 7) + slot]); };
  const int n = gridDim.x * blockDim.x, tid = blockIdx.x * blockDim.x + threadIdx.x;
  int a[kChains], b[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    a[c] = init[c * n + tid];
    b[c] = init[(kChains + c) * n + tid];
  }
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < kSteps; k += 2) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        a[c] = lut(k % kSlots, a[c], b[c]);
        b[c] = lut((k + 1) % kSlots, b[c], a[c]);
      }
    }
  }
  int acc = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc += a[c] + b[c];
  out[tid] = acc;
}

// The ops of ops/float_ops.py, as K2 and K4 compute them.
struct MinSumOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __fmul_rn(__fmul_rn(float_llr::sign_of(a), float_llr::sign_of(b)),
                     fminf(fabsf(a), fabsf(b)));
  }
};
struct BoxPlus {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return float_llr::boxplus(a, b);
  }
};
struct AddClip {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return float_llr::clip_llr(__fadd_rn(a, b));
  }
};
struct Min {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
    float_pair_kernel(const float* init, float* out, int loops) {
  const Op op;
  const int n = gridDim.x * blockDim.x, tid = blockIdx.x * blockDim.x + threadIdx.x;
  float x[kChains], y[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    x[c] = init[c * n + tid];
    y[c] = init[(kChains + c) * n + tid];
  }
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int k = 0; k < kSteps; k += 2) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        x[c] = op(x[c], y[c]);
        y[c] = op(y[c], -x[c]);
      }
    }
  }
  float acc = x[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc = __fadd_rn(acc, x[c]);
  out[tid] = acc;
}

enum Kind {
  kLookup1d = 0, kLookup2d = 1, kMinSumOp = 2, kBoxPlus = 3, kAddClip = 4, kMin = 5,
  kLookup2dLanes = 6,
};

int block_threads(int kind) { return kind == kLookup2dLanes ? kLanesThreads : kThreads; }

size_t lanes_shared_bytes(int t) { return size_t(128) * t * t; }

const void* kernel_of(int kind) {
  switch (kind) {
    case kLookup1d: return reinterpret_cast<const void*>(lookup1d_kernel);
    case kLookup2d: return reinterpret_cast<const void*>(lookup2d_kernel);
    case kMinSumOp: return reinterpret_cast<const void*>(float_pair_kernel<MinSumOp>);
    case kBoxPlus: return reinterpret_cast<const void*>(float_pair_kernel<BoxPlus>);
    case kAddClip: return reinterpret_cast<const void*>(float_pair_kernel<AddClip>);
    case kMin: return reinterpret_cast<const void*>(float_pair_kernel<Min>);
    case kLookup2dLanes: return reinterpret_cast<const void*>(lookup2d_lanes_kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int peaks_threads() { return kThreads; }
int peaks_lanes_threads() { return kLanesThreads; }
int peaks_chains() { return kChains; }
int peaks_steps() { return kSteps; }
int peaks_slots() { return kSlots; }

// Blocks that fill every SM with the kernel of `kind` at table size `t`: the
// SM count times the blocks one SM holds at once.
int peaks_blocks(int kind, int t, int* blocks) {
  const void* kernel = kernel_of(kind);
  if (kernel == nullptr || t < 1 || t > kMaxT) return int(cudaErrorInvalidValue);
  const size_t shared = kind == kLookup2dLanes ? lanes_shared_bytes(t) : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && shared)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shared));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block_threads(kind),
                                                        shared);
  if (err != cudaSuccess) return int(err);
  *blocks = sms * per_sm;
  return 0;
}

// A lookup chain (kind 0: 1-D, 1: 2-D, 6: 2-D with per-lane copies) over
// `blocks` blocks of block_threads(kind) threads on `stream`: `table` holds T
// bytes (1-D) or kSlots LUTs of T x T bytes (2-D), `init` [kChains (1-D) or
// 2 kChains (2-D)][blocks * block_threads] int32 states in [0, T), `out` the
// per-thread sums of the final states.
int peaks_lookup(int kind, const uint8_t* table, const int32_t* init, int32_t* out, int t,
                 int loops, int blocks, void* stream) {
  if (t < 1 || t > kMaxT) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kLookup1d) {
    lookup1d_kernel<<<blocks, kThreads, 0, s>>>(table, init, out, t, loops);
  } else if (kind == kLookup2d) {
    lookup2d_kernel<<<blocks, kThreads, 0, s>>>(table, init, out, t, loops);
  } else if (kind == kLookup2dLanes) {
    const size_t shared = lanes_shared_bytes(t);
    const cudaError_t err = cudaFuncSetAttribute(
        lookup2d_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shared));
    if (err != cudaSuccess) return int(err);
    lookup2d_lanes_kernel<<<blocks, kLanesThreads, shared, s>>>(table, init, out, t, loops);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// Float pair chains of op `kind` (2: min-sum op, 3: boxplus, 4: add + clip,
// 5: min): `init` [2 kChains][blocks * kThreads] (x then y), `out` the
// per-thread sums x_0 + x_1 + ... of the final states, in chain order.
int peaks_float(int kind, const float* init, float* out, int loops, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kMinSumOp: float_pair_kernel<MinSumOp><<<blocks, kThreads, 0, s>>>(init, out, loops); break;
    case kBoxPlus: float_pair_kernel<BoxPlus><<<blocks, kThreads, 0, s>>>(init, out, loops); break;
    case kAddClip: float_pair_kernel<AddClip><<<blocks, kThreads, 0, s>>>(init, out, loops); break;
    case kMin: float_pair_kernel<Min><<<blocks, kThreads, 0, s>>>(init, out, loops); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

const char* peaks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
