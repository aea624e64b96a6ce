// K2: fused float (min-sum / BP) LDPC decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/float_fused.py:_build_float_fused_kernel. It computes what that
// kernel computes, not how: one CTA decodes one tile of `bt` codewords from
// channel LLRs to posterior LLRs with both float32 message views resident in
// shared memory, so no message touches device memory during the decode.
//
// Per tile:
//   seed the CN view A with each row's channel LLR and cache each variable
//   node's channel LLR in group order (CHG);
//   loop, at most imax-1 bodies: CN leave-one-out A -> B (min-sum: min1/min2
//   with leave-one-out signs; BP: pairwise box-plus prefix/suffix), routed on
//   write; VN update clip(ch + sum - m_j, +-150) B -> A, routed on write;
//   syndrome of A (hard bit A < 0) counted per codeword; the tile leaves the
//   loop when no codeword has an unsatisfied check (early exit);
//   imax <= 1 runs no body: the syndrome of the seeded A and a zero B;
//   decision ch + left-fold sum of B, unclamped, written straight to the
//   natural variable index; unsat and iters per codeword.
//
// Semantics match decode/float_common.py (the plain twin) and the JAX
// decoders: the same fold orders, and every add, subtract and multiply is
// an explicitly rounded intrinsic, so nvcc cannot contract or reorder them
// into something torch's elementwise kernels do not compute. Min-sum is exact
// up to the sign of a zero; BP uses expf and log1pf (no fast math). Padding
// columns of the last tile hold LLR 0 and take part in that tile's exit test.
//
// What bounds it on this card (counts from shapes, not measurements): one
// CTA per SM, set by shared memory. On WLAN N=1296 a codeword needs
// (2*4644 + 1296)*4 B = 42,336 B, so a tile is 5 codewords (211.7 KB of the
// 227 KB). Each body reads and writes both views, 4*4644*4 B = 74.3 KB per
// codeword, plus 18.6 KB for the syndrome pass over A and 5.2 KB of channel
// reads; the routed writes scatter, so they meet bank conflicts. BP adds
// 3(d-2) box-plus operations per check, 10,044 per WLAN codeword and body,
// each with two expf and two log1pf: about 40k transcendental calls per
// codeword per body. Device memory carries only the LLRs in and the
// posteriors out. The design is the simple one: one thread per
// (node, codeword) item, strided over 1024 threads, a node's inputs held in
// registers (the degree is a template parameter), and block-wide barriers
// between the passes. Folding the syndrome into the VN writes, and larger or
// half-precision tiles, are later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

// 1024 threads measured faster than 512 for K1 on the same card;
// __launch_bounds__ then caps registers at 64.
constexpr int kThreads = 1024;
constexpr int kMaxDegree = 16;
constexpr float kLlrMax = 150.0f;
constexpr int kMinSum = 0;
constexpr int kBP = 1;

struct Params {
  const float* llrs;         // [n_vars, batch]
  float* outputs;            // [n_vars, batch]
  int32_t* unsat_out;        // [batch]
  int32_t* iters_out;        // [batch]
  const int32_t* seed_var;   // [n_edges] variable of each CN-view row
  const int32_t* node_var;   // [n_vars] variable of each group-ordered VN
  const int32_t* cn_route;   // [n_edges] CN-view row -> VN-view row
  const int32_t* vn_route;   // [n_edges] VN-view row -> CN-view row
  const int32_t* cn_groups;  // [n_cn_groups, 3] (offset, num_nodes, degree)
  const int32_t* vn_groups;  // [n_vn_groups, 4] (offset, num_nodes, degree, node offset)
  int n_cn_groups, n_vn_groups;
  int n_vars, n_edges, batch, bt;
  int imax, early_exit;
};

// Shared-memory carve; float_fused.py:shared_bytes mirrors it.
__host__ __device__ inline size_t shared_bytes(const Params& p) {
  return 2 * sizeof(int) * p.bt  // unsat counts, 2 buffers
         + sizeof(float) * size_t(2 * p.n_edges + p.n_vars) * p.bt;  // A, B, CHG
}

// torch.sign / jnp.sign: +1, -1, and the input itself for +-0 (and NaN).
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ float clip_llr(float x) {
  return fminf(fmaxf(x, -kLlrMax), kLlrMax);
}

// ops/float_ops.py boxplus, operation by operation.
__device__ __forceinline__ float boxplus(float a, float b) {
  const float sgn = __fmul_rn(sign_of(a), sign_of(b));
  const float mag = fminf(fabsf(a), fabsf(b));
  const float corr = __fsub_rn(log1pf(expf(-fabsf(__fadd_rn(a, b)))),
                               log1pf(expf(-fabsf(__fsub_rn(a, b)))));
  return __fadd_rn(__fmul_rn(sgn, mag), corr);
}

// Min-sum check update: every output is (product of the other signs) x
// (smallest other magnitude). The sign product is taken as the parity of the
// other negative inputs, or 0 when another input is 0 (sign(0) = 0): the
// same values as float_ops.py's prefix/suffix products. The magnitude is
// min2 where |m_j| == min1, else min1 (min2 == min1 on ties).
template <int D>
__device__ void cn_minsum_group(const float* __restrict__ src, float* __restrict__ dst,
                                const int32_t* __restrict__ route, int off, int n,
                                int bt) {
  const int items = n * bt;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int node = t / bt;
    const int c = t - node * bt;
    float m[D];
#pragma unroll
    for (int k = 0; k < D; ++k) m[k] = src[(off + k * n + node) * bt + c];
    float out[D];
    if constexpr (D == 2) {
      out[0] = m[1];
      out[1] = m[0];
    } else {
      float min1 = fabsf(m[0]);
      float min2 = INFINITY;
      int zeros = m[0] == 0.f;
      int negs = m[0] < 0.f;
#pragma unroll
      for (int k = 1; k < D; ++k) {
        const float a = fabsf(m[k]);
        min2 = fminf(min2, fmaxf(min1, a));
        min1 = fminf(min1, a);
        zeros += m[k] == 0.f;
        negs ^= m[k] < 0.f;
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float s = zeros - int(m[j] == 0.f) > 0
                            ? 0.f
                            : ((negs ^ int(m[j] < 0.f)) ? -1.f : 1.f);
        out[j] = __fmul_rn(s, fabsf(m[j]) == min1 ? min2 : min1);
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k)
      dst[__ldg(&route[off + k * n + node]) * bt + c] = out[k];
  }
}

// BP check update: the pairwise box-plus fold of float_ops.py
// associative_leave_one_out. suf[k] = fold(m_k..m_{D-1}) = m_k [+] suf[k+1];
// out_0 = suf[1], out_j = pre_{j-1} [+] suf[j+1], out_{D-1} = pre_{D-2},
// with pre_j = pre_{j-1} [+] m_j. Inputs are read again from shared memory
// in the forward walk, so only the suffixes live in registers.
template <int D>
__device__ void cn_bp_group(const float* __restrict__ src, float* __restrict__ dst,
                            const int32_t* __restrict__ route, int off, int n, int bt) {
  const int items = n * bt;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int node = t / bt;
    const int c = t - node * bt;
    const float* in = src + (off + node) * bt + c;  // message k at in[k * n * bt]
    const int32_t* rt = route + off + node;         // its route at rt[k * n]
    if constexpr (D == 2) {
      const float m0 = in[0], m1 = in[n * bt];
      dst[__ldg(&rt[0]) * bt + c] = m1;
      dst[__ldg(&rt[n]) * bt + c] = m0;
    } else {
      float suf[D];
      suf[D - 1] = in[(D - 1) * n * bt];
#pragma unroll
      for (int k = D - 2; k >= 1; --k) suf[k] = boxplus(in[k * n * bt], suf[k + 1]);
      dst[__ldg(&rt[0]) * bt + c] = suf[1];
      float pre = in[0];
#pragma unroll
      for (int j = 1; j < D - 1; ++j) {
        dst[__ldg(&rt[j * n]) * bt + c] = boxplus(pre, suf[j + 1]);
        pre = boxplus(pre, in[j * n * bt]);
      }
      dst[__ldg(&rt[(D - 1) * n]) * bt + c] = pre;
    }
  }
}

// Variable update: total = ch + ((m0 + m1) + m2 ...), out_j =
// clip(total - m_j); degree 1 forwards clip(ch).
template <int D>
__device__ void vn_group(const float* __restrict__ src, float* __restrict__ dst,
                         const float* __restrict__ chg, const int32_t* __restrict__ route,
                         int off, int n, int node_off, int bt) {
  const int items = n * bt;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int node = t / bt;
    const int c = t - node * bt;
    const float ch = chg[(node_off + node) * bt + c];
    if constexpr (D == 1) {
      dst[__ldg(&route[off + node]) * bt + c] = clip_llr(ch);
    } else {
      float m[D];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = src[(off + k * n + node) * bt + c];
      float s = m[0];
#pragma unroll
      for (int k = 1; k < D; ++k) s = __fadd_rn(s, m[k]);
      const float total = __fadd_rn(ch, s);
#pragma unroll
      for (int k = 0; k < D; ++k)
        dst[__ldg(&route[off + k * n + node]) * bt + c] = clip_llr(__fsub_rn(total, m[k]));
    }
  }
}

#define DEGREES_2_TO_16(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)
#define DEGREES_1_TO_16(X) X(1) DEGREES_2_TO_16(X)

template <int RULE>
__device__ void cn_pass(const Params& p, const float* src, float* dst) {
  for (int g = 0; g < p.n_cn_groups; ++g) {
    const int off = p.cn_groups[3 * g], n = p.cn_groups[3 * g + 1];
    switch (p.cn_groups[3 * g + 2]) {
#define CN_CASE(D)                                                  \
  case D:                                                           \
    if constexpr (RULE == kMinSum)                                  \
      cn_minsum_group<D>(src, dst, p.cn_route, off, n, p.bt);       \
    else                                                            \
      cn_bp_group<D>(src, dst, p.cn_route, off, n, p.bt);           \
    break;
      DEGREES_2_TO_16(CN_CASE)
#undef CN_CASE
      default:
        __trap();
    }
  }
}

__device__ void vn_pass(const Params& p, const float* src, float* dst, const float* chg) {
  for (int g = 0; g < p.n_vn_groups; ++g) {
    const int off = p.vn_groups[4 * g], n = p.vn_groups[4 * g + 1];
    const int node_off = p.vn_groups[4 * g + 3];
    switch (p.vn_groups[4 * g + 2]) {
#define VN_CASE(D)                                                  \
  case D:                                                           \
    vn_group<D>(src, dst, chg, p.vn_route, off, n, node_off, p.bt); \
    break;
      DEGREES_1_TO_16(VN_CASE)
#undef VN_CASE
      default:
        __trap();
    }
  }
}

// Per codeword, the number of checks whose inputs in A hold an odd count
// of negative values, added into unsat[c].
__device__ void syndrome_pass(const Params& p, const float* A, int* unsat) {
  for (int g = 0; g < p.n_cn_groups; ++g) {
    const int off = p.cn_groups[3 * g], n = p.cn_groups[3 * g + 1];
    const int d = p.cn_groups[3 * g + 2];
    const int items = n * p.bt;
    for (int t = threadIdx.x; t < items; t += blockDim.x) {
      const int node = t / p.bt;
      const int c = t - node * p.bt;
      int parity = 0;
      for (int k = 0; k < d; ++k) parity ^= A[(off + k * n + node) * p.bt + c] < 0.f;
      if (parity) atomicAdd(&unsat[c], 1);
    }
  }
}

// Decision: ch + ((B_0 + B_1) + ...), unclamped, at the natural index.
__device__ void decide_pass(const Params& p, const float* B, const float* chg, int b0) {
  for (int g = 0; g < p.n_vn_groups; ++g) {
    const int off = p.vn_groups[4 * g], n = p.vn_groups[4 * g + 1];
    const int d = p.vn_groups[4 * g + 2], node_off = p.vn_groups[4 * g + 3];
    const int items = n * p.bt;
    for (int t = threadIdx.x; t < items; t += blockDim.x) {
      const int node = t / p.bt;
      const int c = t - node * p.bt;
      if (b0 + c >= p.batch) continue;
      float s = B[(off + node) * p.bt + c];
      for (int k = 1; k < d; ++k) s = __fadd_rn(s, B[(off + k * n + node) * p.bt + c]);
      p.outputs[size_t(__ldg(&p.node_var[node_off + node])) * p.batch + b0 + c] =
          __fadd_rn(chg[(node_off + node) * p.bt + c], s);
    }
  }
}

template <int RULE>
__global__ void __launch_bounds__(kThreads) float_fused_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bt = p.bt;
  const int b0 = blockIdx.x * bt;
  int* unsat = reinterpret_cast<int*>(smem);  // [2][bt], by body parity
  float* A = reinterpret_cast<float*>(smem + 2 * sizeof(int) * bt);  // CN view
  float* B = A + size_t(p.n_edges) * bt;                             // VN view
  float* CHG = B + size_t(p.n_edges) * bt;  // channel LLR per group-ordered VN

  // Seed: A <- channel LLR of each row's variable; CHG <- channel LLR of each
  // group-ordered variable node. Padding columns 0.
  for (int t = threadIdx.x; t < p.n_edges * bt; t += blockDim.x) {
    const int r = t / bt, col = b0 + t - r * bt;
    A[t] = col < p.batch ? p.llrs[size_t(__ldg(&p.seed_var[r])) * p.batch + col] : 0.f;
  }
  for (int t = threadIdx.x; t < p.n_vars * bt; t += blockDim.x) {
    const int r = t / bt, col = b0 + t - r * bt;
    CHG[t] = col < p.batch ? p.llrs[size_t(__ldg(&p.node_var[r])) * p.batch + col] : 0.f;
  }

  int iters = 0;
  const int* last = unsat;  // the counts reported per codeword
  if (p.imax <= 1) {
    // No body runs: the syndrome of the seeded view and a zero VN view.
    for (int c = threadIdx.x; c < bt; c += blockDim.x) unsat[c] = 0;
    for (int t = threadIdx.x; t < p.n_edges * bt; t += blockDim.x) B[t] = 0.f;
    __syncthreads();
    syndrome_pass(p, A, unsat);
    __syncthreads();
  } else {
    __syncthreads();
    for (int i = 0; i < p.imax - 1; ++i) {
      int* u = unsat + (i & 1) * bt;
      // Without early exit only the last body's syndrome is reported.
      const bool count = p.early_exit || i == p.imax - 2;
      if (count)
        for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
      cn_pass<RULE>(p, A, B);
      __syncthreads();
      vn_pass(p, B, A, CHG);
      __syncthreads();
      iters = i + 1;
      if (count) {
        syndrome_pass(p, A, u);
        __syncthreads();
        last = u;
        if (p.early_exit) {
          // Every thread reads the same counts: the exit is uniform.
          bool any = false;
          for (int c = 0; c < bt; ++c) any |= u[c] > 0;
          if (!any) break;
        }
      }
    }
  }

  decide_pass(p, B, CHG, b0);
  for (int c = threadIdx.x; c < bt; c += blockDim.x) {
    if (b0 + c >= p.batch) continue;
    p.unsat_out[b0 + c] = last[c];
    p.iters_out[b0 + c] = iters;
  }
}

template <int RULE>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = shared_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      float_fused_kernel<RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int grid = (p.batch + p.bt - 1) / p.bt;
  float_fused_kernel<RULE><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt`, one CTA per tile, on `stream`,
// with the min-sum (rule 0) or BP (rule 1) check update. Returns the
// cudaError_t of the attribute call or of the launch.
int float_fused_decode(int rule, const float* llrs, float* outputs, int32_t* unsat_out,
                       int32_t* iters_out, const int32_t* seed_var, const int32_t* node_var,
                       const int32_t* cn_route, const int32_t* vn_route,
                       const int32_t* cn_groups, const int32_t* vn_groups,
                       int n_cn_groups, int n_vn_groups, int n_vars, int n_edges,
                       int batch, int bt, int imax, int early_exit, void* stream) {
  Params p{llrs,     outputs,  unsat_out, iters_out,   seed_var,    node_var,
           cn_route, vn_route, cn_groups, vn_groups,   n_cn_groups, n_vn_groups,
           n_vars,   n_edges,  batch,     bt,          imax,        early_exit};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rule == kMinSum) return launch<kMinSum>(p, s);
  if (rule == kBP) return launch<kBP>(p, s);
  return int(cudaErrorInvalidValue);
}

int float_fused_max_degree() { return kMaxDegree; }

const char* float_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
