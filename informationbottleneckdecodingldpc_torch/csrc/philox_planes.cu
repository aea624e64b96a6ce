// Philox4x32-10 random planes of the Monte-Carlo engine on Hopper (sm_90a).
//
// Replaces XLA code of the JAX reference, not a Pallas kernel: the vmap of
// jax.random.uniform / normal / bernoulli over per-codeword keys in
// informationbottleneckdecodingldpc_tpu/sim/engine.py:376-391 (_step_body).
// Like those keys, every column of a plane is a pure function of the step key
// and the global codeword index, so a batch split into shards draws the same
// codewords. The bits are Philox's (Salmon et al., SC'11, the generator of
// torch's own CUDA random numbers), not JAX's threefry; the plain version,
// sim/rng.py plane_plain, computes the same planes with torch int64 ops.
//
// Counter (global codeword index, 4-word group, stream, 0), key the step's
// 64-bit seed as two words. One thread per (group, codeword), the codeword
// fastest, so a warp writes one row's neighbouring columns. A group gives:
//   uniform (stream 2)  4 float32 in [0, 1) from each word's top 24 bits;
//   normal  (stream 1)  2 float32 by Box-Muller, sqrtf(-2 logf(u1)) *
//                       cosf(2 pi u2) with u1 in (0, 1] from words 0 / 2 and
//                       u2 in [0, 1) from words 1 / 3;
//   bits    (stream 0)  128 int8 bits, bit b of word w for element 32 w + b.
// The source is built without fast math, so logf, sqrtf and cosf are the
// libdevice functions torch's CUDA operators call and the normals equal the
// plain version's on the card, and float(2 pi) rounds as torch rounds the
// Python scalar.
//
// What bounds it (counts from shapes): writing the plane, 4 bytes per
// element (1 per bit), against 10 rounds of 2 multiply-highs per group:
// a WLAN uniform plane of 1296 x 4096 words is 21 MB to write (6.3 us at
// 3.35 TB/s) and 1.3 M Philox groups; the normals add a logf, a sqrtf and a
// cosf per pair of words on the special-function units.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr int kThreads = 256;
constexpr float kTwoPi = float(6.283185307179586);
constexpr float kU24 = 1.0f / 16777216.0f;  // 2^-24

enum Kind { kBits = 0, kNormal = 1, kUniform = 2 };  // = the counter's stream word

// Elements of a plane of `kind` per 4-word group.
__host__ __device__ constexpr int per_group(int kind) {
  return kind == kBits ? 128 : kind == kNormal ? 2 : 4;
}

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t x) { return float(x >> 8) * kU24; }

template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
    plane_kernel(T* out, uint32_t k0, uint32_t k1, uint32_t offset, int rows, int batch,
                 long long items) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < items; t += step) {
    const long long g = t / batch;
    const int i = int(t - g * batch);
    const uint4 v = philox(make_uint4(offset + uint32_t(i), uint32_t(g), uint32_t(K), 0u), k0, k1);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const long long row0 = g * per_group(K);
    if constexpr (K == kUniform) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row0 + e < rows) out[(row0 + e) * batch + i] = uniform24(w[e]);
    } else if constexpr (K == kNormal) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (row0 + e >= rows) break;
        const float u1 = float((w[2 * e] >> 8) + 1u) * kU24;  // (0, 1]
        const float u2 = uniform24(w[2 * e + 1]);
        out[(row0 + e) * batch + i] = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
      }
    } else {
#pragma unroll 4
      for (int e = 0; e < 128; ++e) {
        if (row0 + e >= rows) break;
        out[(row0 + e) * batch + i] = int8_t((w[e >> 5] >> (e & 31)) & 1u);
      }
    }
  }
}

}  // namespace

extern "C" {

// Writes the [rows, batch] plane of `kind` (0 bits int8, 1 normal float32,
// 2 uniform float32) of codewords [offset, offset + batch) under the key
// (k0, k1) into `out` on `stream`.
int philox_plane(int kind, void* out, unsigned k0, unsigned k1, unsigned offset, int rows,
                 int batch, void* stream) {
  if (kind < kBits || kind > kUniform || rows < 1 || batch < 1 ||
      (unsigned long long)offset + batch > (1ull << 32))
    return int(cudaErrorInvalidValue);
  const long long groups = (rows + per_group(kind) - 1) / per_group(kind);
  const long long items = groups * batch;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = int(want < (1 << 20) ? want : (1 << 20));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBits:
      plane_kernel<kBits><<<blocks, kThreads, 0, s>>>(static_cast<int8_t*>(out), k0, k1, offset,
                                                      rows, batch, items);
      break;
    case kNormal:
      plane_kernel<kNormal><<<blocks, kThreads, 0, s>>>(static_cast<float*>(out), k0, k1,
                                                        offset, rows, batch, items);
      break;
    default:
      plane_kernel<kUniform><<<blocks, kThreads, 0, s>>>(static_cast<float*>(out), k0, k1,
                                                         offset, rows, batch, items);
  }
  return int(cudaGetLastError());
}

const char* philox_planes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
