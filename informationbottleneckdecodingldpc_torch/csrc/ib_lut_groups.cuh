// Node folds of the IB lookup-table decoder, shared by K1 (ib_lut_fused.cu,
// both views in shared memory) and K3 (ib_lut_hbm.cu, both views in device
// memory).
//
// A view is [row][bt] bytes: row r of codeword column c at r * bt + c, so a
// caller hands in the base of one tile's slab wherever it lives. A pass walks
// its (node, codeword) items from `first` in steps of `step`: K1 passes
// (threadIdx.x, blockDim.x), K3 a grid-wide stride. Every node output is a
// strict left-to-right fold of its inputs with the own edge removed, step p
// through pairwise LUT p-1 indexed lut[state][next] (ops/lut_fold.py).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ib_lut {

// Pairwise LUTs of one pass: slot l at base + l*slot, row stride `stride`.
struct Luts {
  const uint8_t* base;
  int slot;
  int stride;
  __device__ __forceinline__ uint8_t operator()(int l, int a, int b) const {
    return base[l * slot + a * stride + b];
  }
};

// The degree groups and routes of a decode layout (the arrays of
// kernels/ib_lut_fused.py:layout_arrays) and the tile width.
struct Graph {
  const int32_t* cn_groups;  // [n_cn_groups, 3] (offset, num_nodes, degree)
  const int32_t* vn_groups;  // [n_vn_groups, 4] (offset, num_nodes, degree, node offset)
  const int32_t* cn_route;   // [n_edges] CN-view row -> VN-view row
  const int32_t* vn_route;   // [n_edges] VN-view row -> CN-view row
  const int32_t* node_var;   // [n_vars] variable of each group-ordered VN
  int n_cn_groups, n_vn_groups;
  int bt, t_decoder;
};

// CN leave-one-out of one check node of degree D >= 2 (before alignment).
// `lut(l, a, b)` is pairwise LUT l: Luts, or a layout of the same tables.
template <int D, class Lut>
__device__ __forceinline__ void cn_fold(const uint8_t (&m)[D], uint8_t (&out)[D], Lut lut) {
  if constexpr (D == 2) {
    out[0] = m[1];
    out[1] = m[0];
  } else {
    // Prefixes f[k] = fold(m_0..m_k), k = 1..D-2.
    uint8_t f[D];
    f[1] = lut(0, m[0], m[1]);
#pragma unroll
    for (int k = 2; k < D - 1; ++k) f[k] = lut(k - 1, f[k - 1], m[k]);
    // Output j >= 2 continues prefix f[j-1]; message k takes LUT k-2.
#pragma unroll
    for (int j = 2; j < D; ++j) {
      uint8_t s = f[j - 1];
#pragma unroll
      for (int k = j + 1; k < D; ++k) s = lut(k - 2, s, m[k]);
      out[j] = s;
    }
    uint8_t s0 = lut(0, m[1], m[2]);
    uint8_t s1 = lut(0, m[0], m[2]);
#pragma unroll
    for (int k = 3; k < D; ++k) {
      s0 = lut(k - 2, s0, m[k]);
      s1 = lut(k - 2, s1, m[k]);
    }
    out[0] = s0;
    out[1] = s1;
  }
}

// VN leave-one-out of one variable node of degree D >= 2 with its channel
// cluster `ch` (before alignment).
template <int D, class Lut>
__device__ __forceinline__ void vn_fold(uint8_t ch, const uint8_t (&m)[D], uint8_t (&out)[D],
                                        Lut lut) {
  // Prefixes f[k] = fold(ch, m_0..m_k); message k >= 1 takes LUT k.
  uint8_t f[D];
  f[0] = lut(0, ch, m[0]);
#pragma unroll
  for (int k = 1; k < D - 1; ++k) f[k] = lut(k, f[k - 1], m[k]);
  // Output j continues f[j-1]; message k then takes LUT k-1.
#pragma unroll
  for (int j = 1; j < D; ++j) {
    uint8_t s = f[j - 1];
#pragma unroll
    for (int k = j + 1; k < D; ++k) s = lut(k - 1, s, m[k]);
    out[j] = s;
  }
  uint8_t s0 = lut(0, ch, m[1]);
#pragma unroll
  for (int k = 2; k < D; ++k) s0 = lut(k - 1, s0, m[k]);
  out[0] = s0;
}

template <int D>
__device__ void cn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                         Luts lut, const uint8_t* __restrict__ match_row,
                         const int32_t* __restrict__ route, int off, int n, int bt,
                         int thresh, int* unsat, int first, int step) {
  const int items = n * bt;
  for (int t = first; t < items; t += step) {
    const int node = t / bt;
    const int c = t - node * bt;
    uint8_t m[D];
#pragma unroll
    for (int k = 0; k < D; ++k) m[k] = src[(off + k * n + node) * bt + c];
    if (unsat != nullptr) {
      int parity = 0;
#pragma unroll
      for (int k = 0; k < D; ++k) parity ^= int(m[k] < thresh);
      if (parity) atomicAdd(&unsat[c], 1);
    }
    uint8_t out[D];
    cn_fold<D>(m, out, lut);
#pragma unroll
    for (int k = 0; k < D; ++k)
      dst[__ldg(&route[off + k * n + node]) * bt + c] = match_row[out[k]];
  }
}

template <int D>
__device__ void vn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                         const uint8_t* __restrict__ chg, Luts lut,
                         const uint8_t* __restrict__ match_row,
                         const int32_t* __restrict__ route, int off, int n,
                         int node_off, int bt, int first, int step) {
  const int items = n * bt;
  for (int t = first; t < items; t += step) {
    const int node = t / bt;
    const int c = t - node * bt;
    const uint8_t ch = chg[(node_off + node) * bt + c];
    if constexpr (D == 1) {
      // Degree-1 variable nodes forward the channel, unaligned.
      dst[__ldg(&route[off + node]) * bt + c] = ch;
    } else {
      uint8_t m[D];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = src[(off + k * n + node) * bt + c];
      uint8_t out[D];
      vn_fold<D>(ch, m, out, lut);
#pragma unroll
      for (int k = 0; k < D; ++k)
        dst[__ldg(&route[off + k * n + node]) * bt + c] = match_row[out[k]];
    }
  }
}

template <int D>
__device__ void decide_group(const uint8_t* __restrict__ src,
                             const uint8_t* __restrict__ chg, Luts lut,
                             const int32_t* __restrict__ node_var,
                             int32_t* __restrict__ outputs, int off, int n,
                             int node_off, int bt, int b0, int batch, int first,
                             int step) {
  const int items = n * bt;
  for (int t = first; t < items; t += step) {
    const int node = t / bt;
    const int c = t - node * bt;
    if (b0 + c >= batch) continue;
    uint8_t s = lut(0, chg[(node_off + node) * bt + c], src[(off + node) * bt + c]);
#pragma unroll
    for (int k = 1; k < D; ++k) s = lut(k, s, src[(off + k * n + node) * bt + c]);
    outputs[size_t(__ldg(&node_var[node_off + node])) * batch + b0 + c] = s;
  }
}

#define IB_DEGREES_2_TO_16(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)
#define IB_DEGREES_1_TO_16(X) X(1) IB_DEGREES_2_TO_16(X)

// CN leave-one-out of every check group, src (CN view) -> dst (VN view),
// aligned by `match` (rows [d_c_max][T]); with `unsat`, the syndrome of the
// inputs (hard bit t < T/2) is added per codeword column.
__device__ inline void cn_pass(const Graph& g, const uint8_t* src, uint8_t* dst,
                               Luts lut, const uint8_t* match, int* unsat, int first,
                               int step) {
  for (int k = 0; k < g.n_cn_groups; ++k) {
    const int off = g.cn_groups[3 * k], n = g.cn_groups[3 * k + 1];
    const int d = g.cn_groups[3 * k + 2];
    const uint8_t* row = match + (d - 1) * g.t_decoder;
    switch (d) {
#define IB_CN_CASE(D)                                                               \
  case D:                                                                           \
    cn_group<D>(src, dst, lut, row, g.cn_route, off, n, g.bt, g.t_decoder / 2,      \
                unsat, first, step);                                                \
    break;
      IB_DEGREES_2_TO_16(IB_CN_CASE)
#undef IB_CN_CASE
      default:
        __trap();
    }
  }
}

// VN leave-one-out of every variable group with the channel clusters `chg`
// ([n_vars][bt], group order), src (VN view) -> dst (CN view).
__device__ inline void vn_pass(const Graph& g, const uint8_t* src, uint8_t* dst,
                               const uint8_t* chg, Luts lut, const uint8_t* match,
                               int first, int step) {
  for (int k = 0; k < g.n_vn_groups; ++k) {
    const int off = g.vn_groups[4 * k], n = g.vn_groups[4 * k + 1];
    const int d = g.vn_groups[4 * k + 2], node_off = g.vn_groups[4 * k + 3];
    const uint8_t* row = match + (d - 1) * g.t_decoder;
    switch (d) {
#define IB_VN_CASE(D)                                                                 \
  case D:                                                                             \
    vn_group<D>(src, dst, chg, lut, row, g.vn_route, off, n, node_off, g.bt, first,   \
                step);                                                                \
    break;
      IB_DEGREES_1_TO_16(IB_VN_CASE)
#undef IB_VN_CASE
      default:
        __trap();
    }
  }
}

// Decision fold of every variable node, written to outputs[var][batch] at
// columns b0 + c < batch.
__device__ inline void decide_pass(const Graph& g, const uint8_t* src, const uint8_t* chg,
                                   Luts lut, int32_t* outputs, int b0, int batch,
                                   int first, int step) {
  for (int k = 0; k < g.n_vn_groups; ++k) {
    const int off = g.vn_groups[4 * k], n = g.vn_groups[4 * k + 1];
    const int d = g.vn_groups[4 * k + 2], node_off = g.vn_groups[4 * k + 3];
    switch (d) {
#define IB_DEC_CASE(D)                                                                \
  case D:                                                                             \
    decide_group<D>(src, chg, lut, g.node_var, outputs, off, n, node_off, g.bt, b0,   \
                    batch, first, step);                                              \
    break;
      IB_DEGREES_1_TO_16(IB_DEC_CASE)
#undef IB_DEC_CASE
      default:
        __trap();
    }
  }
}

}  // namespace ib_lut
