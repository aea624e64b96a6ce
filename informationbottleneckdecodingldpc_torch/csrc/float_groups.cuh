// Node rules of the float (min-sum / BP) decoders, shared by K2
// (float_fused.cu, both views in shared memory) and K4 (float_hbm.cu, both
// views in device memory).
//
// A view is float32 [row][bt]: row r of codeword column c at r * bt + c, so a
// caller hands in the base of one tile's slab wherever it lives. The folds
// take one node's messages in registers; K2 and K4 walk their items each
// their own way. The syndrome-only pass below (K4's, and K2's after its
// last body) and K4's decision pass walk the (node, codeword) items of one
// tile from `first` in steps of `step`.
//
// Semantics match decode/float_common.py (the plain twin) and the JAX
// decoders: the same fold orders, and every add, subtract and multiply is an
// explicitly rounded intrinsic, so nvcc cannot contract or reorder them into
// something torch's elementwise kernels do not compute. Min-sum is exact up
// to the sign of a zero; BP uses expf and log1pf (no fast math).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace float_llr {

constexpr float kLlrMax = 150.0f;
constexpr int kMinSum = 0;
constexpr int kBP = 1;

// The degree groups and routes of a decode layout (the arrays of
// kernels/ib_lut_fused.py:layout_arrays) and the tile width.
struct Graph {
  const int32_t* cn_groups;  // [n_cn_groups, 3] (offset, num_nodes, degree)
  const int32_t* vn_groups;  // [n_vn_groups, 4] (offset, num_nodes, degree, node offset)
  const int32_t* cn_route;   // [n_edges] CN-view row -> VN-view row
  const int32_t* vn_route;   // [n_edges] VN-view row -> CN-view row
  const int32_t* node_var;   // [n_vars] variable of each group-ordered VN
  int n_cn_groups, n_vn_groups;
  int bt;
};

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
// min2 where |m_j| == min1, else min1 (min2 == min1 on ties). Returns the
// parity of the negative inputs: 1 for a check the inputs' hard bits leave
// unsatisfied.
template <int D>
__device__ __forceinline__ int minsum_fold(const float (&m)[D], float (&out)[D]) {
  if constexpr (D == 2) {
    out[0] = m[1];
    out[1] = m[0];
    return (m[0] < 0.f) ^ (m[1] < 0.f);
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
    return negs;
  }
}

// BP check update with the inputs in registers: the pairwise box-plus fold
// of float_ops.py associative_leave_one_out, operation for operation (K2's
// cn_bp_item computes the same sequence with the inputs read twice).
template <int D>
__device__ __forceinline__ void bp_fold(const float (&m)[D], float (&out)[D]) {
  if constexpr (D == 2) {
    out[0] = m[1];
    out[1] = m[0];
  } else {
    float suf[D];
    suf[D - 1] = m[D - 1];
#pragma unroll
    for (int k = D - 2; k >= 1; --k) suf[k] = boxplus(m[k], suf[k + 1]);
    out[0] = suf[1];
    float pre = m[0];
#pragma unroll
    for (int j = 1; j < D - 1; ++j) {
      out[j] = boxplus(pre, suf[j + 1]);
      pre = boxplus(pre, m[j]);
    }
    out[D - 1] = pre;
  }
}

// Posterior of one variable node of degree D >= 2: ch + ((m0 + m1) + m2 ...);
// its outputs are clip(total - m_j).
template <int D>
__device__ __forceinline__ float vn_total(float ch, const float (&m)[D]) {
  float s = m[0];
#pragma unroll
  for (int k = 1; k < D; ++k) s = __fadd_rn(s, m[k]);
  return __fadd_rn(ch, s);
}

// Per codeword, the number of checks whose inputs in A hold an odd count of
// negative values, added into unsat[c].
__device__ inline void syndrome_pass(const Graph& g, const float* A, int* unsat, int first,
                                     int step) {
  for (int k = 0; k < g.n_cn_groups; ++k) {
    const int off = g.cn_groups[3 * k], n = g.cn_groups[3 * k + 1];
    const int d = g.cn_groups[3 * k + 2];
    const int items = n * g.bt;
    for (int t = first; t < items; t += step) {
      const int node = t / g.bt;
      const int c = t - node * g.bt;
      int parity = 0;
      for (int j = 0; j < d; ++j) parity ^= A[(off + j * n + node) * g.bt + c] < 0.f;
      if (parity) atomicAdd(&unsat[c], 1);
    }
  }
}

// Decision: ch + ((B_0 + B_1) + ...), unclamped, written to
// outputs[var][batch] at columns b0 + c < batch.
__device__ inline void decide_pass(const Graph& g, const float* B, const float* chg,
                                   float* outputs, int b0, int batch, int first,
                                   int step) {
  for (int k = 0; k < g.n_vn_groups; ++k) {
    const int off = g.vn_groups[4 * k], n = g.vn_groups[4 * k + 1];
    const int d = g.vn_groups[4 * k + 2], node_off = g.vn_groups[4 * k + 3];
    const int items = n * g.bt;
    for (int t = first; t < items; t += step) {
      const int node = t / g.bt;
      const int c = t - node * g.bt;
      if (b0 + c >= batch) continue;
      float s = B[(off + node) * g.bt + c];
      for (int j = 1; j < d; ++j) s = __fadd_rn(s, B[(off + j * n + node) * g.bt + c]);
      outputs[size_t(__ldg(&g.node_var[node_off + node])) * batch + b0 + c] =
          __fadd_rn(chg[(node_off + node) * g.bt + c], s);
    }
  }
}

}  // namespace float_llr
