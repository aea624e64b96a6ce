// Channel input of the Monte-Carlo engine on Hopper (sm_90a): Philox4x32-10
// draws turned in registers into what the decoder reads, one pass from the
// counter to the decoder's input.
//
// Replaces XLA code of the JAX reference, not a Pallas kernel: the vmap of
// jax.random.uniform / normal / bernoulli over per-codeword keys and the
// sampling, AWGN and quantizer ops around it that XLA fuses into one pass
// (informationbottleneckdecodingldpc_tpu/sim/engine.py:374-438, _step_body).
// Like those keys, every column is a pure function of the step key and the
// global codeword index, so a batch split into shards draws the same
// codewords. The bits are Philox's (Salmon et al., SC'11, the generator of
// torch's own CUDA random numbers), not JAX's threefry; the plain versions,
// sim/rng.py plane_plain and channel_input_plain, compute the same values
// with torch ops.
//
// Counter (global codeword index, 4-word group, stream, 0), key the step's
// 64-bit seed as two words. A group gives:
//   uniform (stream 2)  4 float32 in [0, 1) from each word's top 24 bits;
//   normal  (stream 1)  2 float32 by Box-Muller, sqrtf(-2 logf(u1)) *
//                       cosf(2 pi u2) with u1 in (0, 1] from words 0 / 2 and
//                       u2 in [0, 1) from words 1 / 3;
//   bits    (stream 0)  128 int8 bits, bit b of word w for element 32 w + b.
// One template over (draw, consumer, codeword) writes either the plane
// itself (the identity consumer, rng.draw) or the decoder's input:
//   clusters  #{w : thr[w] < x}, x the uniform (thresholds cdf[1..T-1]) or
//             y = (1 - 2c) + s n (thresholds limits[1..T-1]), int32;
//   llrs      llrs[that count], float32;
//   true      (2 y) * (1 / sigma^2), float32: what torch's CUDA division by a
//             Python scalar computes (it multiplies by the float32 reciprocal).
// Every multiply and add is an __f*_rn intrinsic, so nvcc contracts none into
// an FMA: torch rounds each of its operators separately. The source is built
// without fast math, so logf, sqrtf and cosf are the libdevice functions
// torch's CUDA operators call and the values equal the plain version's on the
// card. The count is a branch-free binary search over 32 slots in shared
// memory (the T - 1 <= 31 thresholds, then +inf): for ascending thresholds it
// is searchsorted's left count, five conflict-free loads (every slot has a
// bank of its own).
//
// What bounds it: the output, 4 bytes per element (1 per bit), and for the
// normals about as much FP32 work, libdevice's logf, sqrtf and cosf
// (utils/roofline.py channel_input_ops; chip_smoke.py counts Box-Muller's
// instructions from cuobjdump -sass). On the card the normal kinds are held
// by the issue of all their instructions, about three times that work. The
// design keeps everything between the counter and the output in
// registers: the parent wrote a float32 plane and two to five torch operators
// read it back. A thread takes 4 adjacent codeword columns of one group row,
// its four Philox chains unrolled side by side with the round keys shared, and
// writes each output row with one 16-byte store (4 bytes for bits); a 2-D grid
// (column quads x group rows) gives every thread its first column and group
// without a division.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr float kTwoPi = float(6.283185307179586);
constexpr float kU24 = 1.0f / 16777216.0f;  // 2^-24
constexpr int kCols = 4;                    // adjacent codeword columns per thread
constexpr int kBlockX = 64, kBlockY = 4;    // threads along column quads x group rows
constexpr int kMaxGridY = 65535;            // group-row blocks of a grid at most
constexpr int kSlots = 32;                  // threshold slots of the binary search

enum Draw { kBits = 0, kNormal = 1, kUniform = 2 };  // = the counter's stream word
enum Out { kPlane = 0, kClusters = 1, kLlrs = 2, kTrue = 3 };

// The C interface's kinds: (draw, consumer, codeword read).
enum Kind {
  kBitsPlane, kNormalPlane, kUniformPlane,      // rng.draw's planes
  kUniformClusters, kUniformLlrs, kNormalTrue,  // the all-zeros chain
  kEncodedClusters, kEncodedLlrs, kEncodedTrue, // the encoded chain
  kKinds
};

// Elements of a column of `draw` per 4-word group.
__host__ __device__ constexpr int per_group(int draw) {
  return draw == kBits ? 128 : draw == kNormal ? 2 : 4;
}

template <int D, int O>
using out_t = std::conditional_t<D == kBits, int8_t, std::conditional_t<O == kClusters, int32_t, float>>;

struct Args {
  void* out;
  const int8_t* codeword;  // [rows, batch] transmitted bits (encoded kinds)
  const float* thresholds;
  int n_thresholds;
  const float* llrs;
  int n_llrs;
  float s;           // float32(sqrt(sigma^2))
  float inv_sigma2;  // float32(1) / float32(sigma^2)
  uint32_t k0, k1, offset;
  int rows, batch, groups;
};

// Philox4x32-10 of the kCols counters in `c`, in place: the chains unrolled
// side by side, each round's key computed once for all of them.
__device__ __forceinline__ void philox(uint32_t (&c)[kCols][4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const uint32_t lo0 = kM0 * c[j][0], hi0 = __umulhi(kM0, c[j][0]);
      const uint32_t lo1 = kM1 * c[j][2], hi1 = __umulhi(kM1, c[j][2]);
      c[j][0] = hi1 ^ c[j][1] ^ k0;
      c[j][1] = lo1;
      c[j][2] = hi0 ^ c[j][3] ^ k1;
      c[j][3] = lo0;
    }
  }
}

__device__ __forceinline__ float uniform24(uint32_t x) { return __fmul_rn(float(x >> 8), kU24); }

// Box-Muller's cosine output from words a (u1 in (0, 1]) and b (u2 in [0, 1)).
__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float u1 = __fmul_rn(float((a >> 8) + 1u), kU24);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, uniform24(b))));
}

// #{w < 31 : thr[w] < x} for ascending thr (searchsorted's left count),
// branch-free.
__device__ __forceinline__ int count_below(const float* thr, float x) {
  int t = 0;
#pragma unroll
  for (int step = kSlots / 2; step; step >>= 1) t += thr[t + step - 1] < x ? step : 0;
  return t;
}

// What the decoder reads of a drawn uniform or normal x of a codeword bit c.
template <int D, int O>
__device__ __forceinline__ out_t<D, O> consume(float x, int c, float s, float inv_sigma2,
                                               const float* thr, const float* llr) {
  if constexpr (O == kPlane) {
    return x;
  } else {
    float v = x;
    if constexpr (D == kNormal) v = __fadd_rn(c ? -1.0f : 1.0f, __fmul_rn(s, x));  // y
    if constexpr (O == kTrue) {
      return __fmul_rn(__fmul_rn(2.0f, v), inv_sigma2);
    } else {
      const int t = count_below(thr, v);
      if constexpr (O == kClusters) return t;
      else return llr[t];
    }
  }
}

template <typename T>
struct Vec4;
template <>
struct Vec4<float> { using type = float4; };
template <>
struct Vec4<int32_t> { using type = int4; };
template <>
struct Vec4<int8_t> { using type = char4; };

// Row `at` of the thread's kCols columns: one vector store when V, else one
// store per column inside the batch.
template <bool V, typename T>
__device__ __forceinline__ void put(T* out, size_t at, const T (&v)[kCols], int live) {
  if constexpr (V) {
    using W = typename Vec4<T>::type;
    *reinterpret_cast<W*>(out + at) = W{v[0], v[1], v[2], v[3]};
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < live) out[at + j] = v[j];
  }
}

template <int D, int O, bool C, bool V>
__global__ void __launch_bounds__(kBlockX * kBlockY) channel_input_kernel(const Args a) {
  using T = out_t<D, O>;
  constexpr bool kSearch = O == kClusters || O == kLlrs;
  __shared__ float thr[kSlots], llr[kSlots];
  if constexpr (kSearch) {
    const int t = threadIdx.y * kBlockX + threadIdx.x;
    if (t < kSlots) {
      thr[t] = t < a.n_thresholds ? a.thresholds[t] : CUDART_INF_F;
      if constexpr (O == kLlrs) llr[t] = t < a.n_llrs ? a.llrs[t] : 0.0f;
    }
    __syncthreads();
  }
  const int i0 = (blockIdx.x * kBlockX + threadIdx.x) * kCols;
  if (i0 >= a.batch) return;
  const int live = a.batch - i0;  // columns of this quad inside the batch (>= kCols: all)
  T* out = static_cast<T*>(a.out);
  for (int g = blockIdx.y * kBlockY + threadIdx.y; g < a.groups; g += gridDim.y * kBlockY) {
    uint32_t w[kCols][4];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      w[j][0] = a.offset + uint32_t(i0 + j);
      w[j][1] = uint32_t(g);
      w[j][2] = uint32_t(D);
      w[j][3] = 0u;
    }
    philox(w, a.k0, a.k1);
    const int row0 = g * per_group(D);
    if constexpr (D == kBits) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const int row = row0 + 32 * q + b;
          if (row >= a.rows) break;
          T v[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) v[j] = T((w[j][q] >> b) & 1u);
          put<V>(out, size_t(row) * a.batch + i0, v, live);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < per_group(D); ++e) {
        const int row = row0 + e;
        if (row >= a.rows) continue;
        const size_t at = size_t(row) * a.batch + i0;
        int c[kCols] = {0, 0, 0, 0};
        if constexpr (C) {
          if constexpr (V) {
            const char4 b = *reinterpret_cast<const char4*>(a.codeword + at);
            c[0] = b.x, c[1] = b.y, c[2] = b.z, c[3] = b.w;
          } else {
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              if (j < live) c[j] = a.codeword[at + j];
          }
        }
        T v[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float x;
          if constexpr (D == kUniform) x = uniform24(w[j][e]);
          else x = box_muller(w[j][2 * e], w[j][2 * e + 1]);
          v[j] = consume<D, O>(x, c[j], a.s, a.inv_sigma2, thr, llr);
        }
        put<V>(out, at, v, live);
      }
    }
  }
}

template <int D, int O, bool C>
void launch(const Args& a, bool vec, cudaStream_t s) {
  const int quads = (a.batch + kCols - 1) / kCols;
  const int rows = (a.groups + kBlockY - 1) / kBlockY;
  const dim3 grid((quads + kBlockX - 1) / kBlockX, rows < kMaxGridY ? rows : kMaxGridY);
  const dim3 block(kBlockX, kBlockY);
  if (vec)
    channel_input_kernel<D, O, C, true><<<grid, block, 0, s>>>(a);
  else
    channel_input_kernel<D, O, C, false><<<grid, block, 0, s>>>(a);
}

}  // namespace

extern "C" {

// Writes the [rows, batch] output of `kind` (Kind above) of codewords
// [offset, offset + batch) under the key (k0, k1) into `out` on `stream`, on
// a grid of column quads x group rows (the group rows past kMaxGridY blocks
// taken in strides), with one 16-byte store a row (4 bytes for bits) where
// batch is a multiple of kCols and `out` (and `codeword`) are aligned for it.
// The search kinds take the thresholds (cdf[1..T-1] for a uniform,
// limits[1..T-1] for a normal) and the llr kinds the T llrs; the encoded
// kinds the int8 codeword plane.
int philox_channel_input(int kind, void* out, const void* codeword, const void* thresholds,
                         int n_thresholds, const void* llrs, int n_llrs, float s, float inv_sigma2,
                         unsigned k0, unsigned k1, unsigned offset, int rows, int batch,
                         void* stream) {
  if (kind < 0 || kind >= kKinds || rows < 1 || batch < 1 ||
      (unsigned long long)offset + batch > (1ull << 32) || !out)
    return int(cudaErrorInvalidValue);
  const bool search = kind == kUniformClusters || kind == kUniformLlrs ||
                      kind == kEncodedClusters || kind == kEncodedLlrs;
  const bool with_llrs = kind == kUniformLlrs || kind == kEncodedLlrs;
  const bool encoded = kind >= kEncodedClusters;
  if ((search && (!thresholds || n_thresholds < 1 || n_thresholds >= kSlots)) ||
      (with_llrs && (!llrs || n_llrs < 1 || n_llrs > kSlots)) || (encoded && !codeword))
    return int(cudaErrorInvalidValue);
  const int draw = kind == kBitsPlane ? kBits : kind == kUniformPlane || kind == kUniformClusters ||
                                                        kind == kUniformLlrs
                                                    ? kUniform
                                                    : kNormal;
  const Args a{out, static_cast<const int8_t*>(codeword), static_cast<const float*>(thresholds),
               n_thresholds, static_cast<const float*>(llrs), n_llrs, s, inv_sigma2, k0, k1, offset,
               rows, batch, (rows + per_group(draw) - 1) / per_group(draw)};
  const bool vec = batch % kCols == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codeword) % 4 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBitsPlane: launch<kBits, kPlane, false>(a, vec, st); break;
    case kNormalPlane: launch<kNormal, kPlane, false>(a, vec, st); break;
    case kUniformPlane: launch<kUniform, kPlane, false>(a, vec, st); break;
    case kUniformClusters: launch<kUniform, kClusters, false>(a, vec, st); break;
    case kUniformLlrs: launch<kUniform, kLlrs, false>(a, vec, st); break;
    case kNormalTrue: launch<kNormal, kTrue, false>(a, vec, st); break;
    case kEncodedClusters: launch<kNormal, kClusters, true>(a, vec, st); break;
    case kEncodedLlrs: launch<kNormal, kLlrs, true>(a, vec, st); break;
    default: launch<kNormal, kTrue, true>(a, vec, st);
  }
  return int(cudaGetLastError());
}

const char* philox_planes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
