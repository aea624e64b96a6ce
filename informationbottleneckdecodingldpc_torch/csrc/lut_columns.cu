// P1: packed-LUT column builds on CUDA cores against tensor cores, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU probe of the JAX reference's
// scripts/mxu_col_probe.py: vpu_variant (compare-select column builds on the
// vector unit) and mxu_variant (the same columns as a one-hot f32 matmul on
// the matrix unit). Both run the same chain per element, `loops` steps:
//
//   cols[k] = packed[k][b]                (k < W: the column of the packed LUT)
//   e       = extract(cols, b & (T1-1), fb)   (ops/lut_fold.py _extract)
//   b       = (e + b) & (T1-1);  acc += cols[0]
//
// and write acc + b (wrapping int32). Two configurations: T1 = 16 with 4-bit
// fields in W = 2 words, and T1 = 32 with split packing (fb = 5: four words
// of low nibbles and one word of high bits, W = 5).
//
// cuda_cores: the W x T1 packed words lie in shared memory; a column build is
// W ld.shared, each lane's word of a row in its own bank (T1 <= 32 words), so
// there are no bank conflicts. Each thread runs kPer independent elements.
// Bound: the shared-memory load pipe, 32 lookups per SM and clock (W per
// element-step), then the extract's integer work.
//
// tensor_cores: one-hot(b) [16 elements, T1] times the byte matrix
// [T1, 4W] (byte n of column b is byte n % 4 of packed[n / 4][b]) on
// mma.sync.m16n8k16 f16 x f16 -> f32: a byte is exact in f16 and a single 1
// per row keeps the f32 sum exact. T1 = 32 takes two k-steps and 4W = 20
// columns padded to 24 (three n-tiles). A warp holds kTiles tiles of 16
// elements in the accumulator layout: the thread with group g = lane / 4 and
// q = lane % 4 owns rows g and g + 8 of each tile, exactly the rows of its A
// fragment, so its one-hot A comes from its own b without a shuffle. Its
// accumulator holds bytes 2q % 4 and 2q % 4 + 1 of word 2 n-tile + q / 2 of
// those rows: one __shfl_xor with lane ^ 1 completes the word, one with
// lane ^ 2 fetches the other word of the n-tile. All four threads of a group
// then hold every word of rows g and g + 8 and run the extract redundantly,
// which keeps the next step's A fragment local. Bound: the tensor cores,
// 2 * 16 * 8 * 16 flops per mma and k-steps x n-tiles mma per 16
// element-steps; in practice the shuffles and the redundant extracts.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;    // elements per thread (cuda_cores)
constexpr int kTiles = 4;  // 16-element tiles per warp (tensor_cores)
constexpr int kCudaBlockElements = kThreads * kPer;
constexpr int kTensorBlockElements = (kThreads / 32) * kTiles * 16;

// Field `a` of the packed column (ops/lut_fold.py _extract): word select and
// a shift; fb = 5 is split packing, the low nibble from words 0..W-2 and the
// high bit from word W-1.
template <int FB, int W>
__device__ __forceinline__ uint32_t extract(const uint32_t (&cols)[W], int a) {
  if constexpr (FB == 5) {
    uint32_t word = cols[0];
#pragma unroll
    for (int k = 1; k < W - 1; ++k) word = (a >> 3) == k ? cols[k] : word;
    return ((word >> (4 * (a & 7))) & 15u) | (((cols[W - 1] >> (a & 31)) & 1u) << 4);
  } else {
    constexpr int kPerWord = 32 / FB;
    constexpr int kShift = kPerWord == 8 ? 3 : kPerWord == 4 ? 2 : kPerWord == 16 ? 4 : 5;
    uint32_t word = cols[0];
#pragma unroll
    for (int k = 1; k < W; ++k) word = (a >> kShift) == k ? cols[k] : word;
    return (word >> (FB * (a & (kPerWord - 1)))) & ((1u << FB) - 1u);
  }
}

template <int T1, int FB, int W>
__global__ void __launch_bounds__(kThreads)
    cuda_cores_kernel(const int32_t* packed, const int32_t* b0, int32_t* out, int loops) {
  __shared__ uint32_t tab[W * T1];
  for (int i = threadIdx.x; i < W * T1; i += kThreads) tab[i] = uint32_t(packed[i]);
  __syncthreads();
  const int base = blockIdx.x * kCudaBlockElements + threadIdx.x;
  uint32_t b[kPer], acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    b[c] = uint32_t(b0[base + c * kThreads]) & (T1 - 1);
    acc[c] = 0;
  }
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      uint32_t cols[W];
#pragma unroll
      for (int k = 0; k < W; ++k) cols[k] = tab[k * T1 + b[c]];
      const uint32_t e = extract<FB, W>(cols, int(b[c]) & (T1 - 1));
      acc[c] += cols[0];
      b[c] = (e + b[c]) & (T1 - 1);
    }
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) out[base + c * kThreads] = int32_t(acc[c] + b[c]);
}

__device__ __forceinline__ uint32_t half2_bits(uint32_t lo, uint32_t hi) {
  // Two small non-negative integers as f16 (exact up to 2048), low half first.
  const unsigned short l = __half_as_ushort(__uint2half_rn(lo));
  const unsigned short h = __half_as_ushort(__uint2half_rn(hi));
  return uint32_t(l) | (uint32_t(h) << 16);
}

// The f16 pair (b == k0, b == k0 + 1): 1.0 is 0x3C00.
__device__ __forceinline__ uint32_t one_hot2(uint32_t b, uint32_t k0) {
  return (b == k0 ? 0x3C00u : 0u) | (b == k0 + 1 ? 0x3C000000u : 0u);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int T1, int FB, int W>
__global__ void __launch_bounds__(kThreads)
    tensor_cores_kernel(const int32_t* packed, const int32_t* b0, int32_t* out, int loops) {
  constexpr int KT = T1 / 16;           // k-steps
  constexpr int NT = (4 * W + 7) / 8;   // n-tiles of 8 byte columns
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int base = warp * kTiles * 16;

  // B fragments of the byte matrix, fixed for the whole chain: rows
  // (k) 16 kk + 2q, +1 and +8, +9, column (n) 8 nt + g.
  auto byte_of = [&](int k, int n) -> uint32_t {
    return n < 4 * W ? (uint32_t(packed[(n >> 2) * T1 + k]) >> (8 * (n & 3))) & 255u : 0u;
  };
  uint32_t bf[KT][NT][2];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int k = 16 * kk + 2 * q, n = 8 * nt + g;
      bf[kk][nt][0] = half2_bits(byte_of(k, n), byte_of(k + 1, n));
      bf[kk][nt][1] = half2_bits(byte_of(k + 8, n), byte_of(k + 9, n));
    }
  }

  uint32_t b[kTiles][2], acc[kTiles][2];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      b[m][h] = uint32_t(b0[base + 16 * m + g + 8 * h]) & (T1 - 1);
      acc[m][h] = 0;
    }
  }
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      float d[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint32_t k0 = 16 * kk + 2 * q;
        const uint32_t a[4] = {one_hot2(b[m][0], k0), one_hot2(b[m][1], k0),
                               one_hot2(b[m][0], k0 + 8), one_hot2(b[m][1], k0 + 8)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma16816(d[nt], a, bf[kk][nt][0], bf[kk][nt][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t cols[2 * NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // Bytes 2q % 4 and 2q % 4 + 1 of word 2 nt + q / 2 of row g + 8h.
          const uint32_t part = (uint32_t(d[nt][2 * h]) | (uint32_t(d[nt][2 * h + 1]) << 8))
                                << (16 * (q & 1));
          const uint32_t word = part | __shfl_xor_sync(0xffffffffu, part, 1);
          const uint32_t other = __shfl_xor_sync(0xffffffffu, word, 2);
          cols[2 * nt] = (q >> 1) ? other : word;
          cols[2 * nt + 1] = (q >> 1) ? word : other;
        }
        uint32_t used[W];
#pragma unroll
        for (int k = 0; k < W; ++k) used[k] = cols[k];
        const uint32_t e = extract<FB, W>(used, int(b[m][h]));
        acc[m][h] += used[0];
        b[m][h] = (e + b[m][h]) & (T1 - 1);
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) out[base + 16 * m + g + 8 * h] = int32_t(acc[m][h] + b[m][h]);
    }
  }
}

enum Variant { kCudaCores = 0, kTensorCores = 1 };

const void* kernel_of(int variant, int t1) {
  if (variant == kCudaCores) {
    if (t1 == 16) return reinterpret_cast<const void*>(cuda_cores_kernel<16, 4, 2>);
    if (t1 == 32) return reinterpret_cast<const void*>(cuda_cores_kernel<32, 5, 5>);
  } else if (variant == kTensorCores) {
    if (t1 == 16) return reinterpret_cast<const void*>(tensor_cores_kernel<16, 4, 2>);
    if (t1 == 32) return reinterpret_cast<const void*>(tensor_cores_kernel<32, 5, 5>);
  }
  return nullptr;
}

int block_elements(int variant) {
  return variant == kCudaCores ? kCudaBlockElements : kTensorBlockElements;
}

}  // namespace

extern "C" {

int lut_columns_block_elements(int variant) { return block_elements(variant); }

// Elements of a launch of `variant` at T1 = `t1` that fills every SM: the SM
// count times the blocks one SM holds at once times a block's elements.
int lut_columns_elements_to_fill(int variant, int t1, int* elements) {
  const void* kernel = kernel_of(variant, t1);
  if (kernel == nullptr) return int(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  *elements = sms * per_sm * block_elements(variant);
  return 0;
}

// The chain of `variant` (0: cuda_cores, 1: tensor_cores) at T1 = `t1` (16:
// fb 4, W 2; 32: fb 5, W 5) over `elements` int32 elements of `b0` (a
// multiple of the variant's block elements), `loops` steps: `packed` [W][T1]
// int32, `out` [elements] int32.
int lut_columns_chain(int variant, int t1, const int32_t* packed, const int32_t* b0, int32_t* out,
                      int elements, int loops, void* stream) {
  const void* kernel = kernel_of(variant, t1);
  const int per_block = block_elements(variant);
  if (kernel == nullptr || elements <= 0 || elements % per_block) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = elements / per_block;
  if (variant == kCudaCores) {
    if (t1 == 16) cuda_cores_kernel<16, 4, 2><<<blocks, kThreads, 0, s>>>(packed, b0, out, loops);
    else cuda_cores_kernel<32, 5, 5><<<blocks, kThreads, 0, s>>>(packed, b0, out, loops);
  } else {
    if (t1 == 16) tensor_cores_kernel<16, 4, 2><<<blocks, kThreads, 0, s>>>(packed, b0, out, loops);
    else tensor_cores_kernel<32, 5, 5><<<blocks, kThreads, 0, s>>>(packed, b0, out, loops);
  }
  return int(cudaGetLastError());
}

const char* lut_columns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
