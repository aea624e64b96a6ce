// Node folds of the IB lookup-table decoder, shared by K1 (ib_lut_fused.cu,
// both views in shared memory) and K3 (ib_lut_hbm.cu, both views in device
// memory).
//
// A view is [row][bt] messages: row r of codeword column c at r * bt + c, a
// byte each (K3 packs two a byte at |T| <= 16, hbm_wide.cuh); the folds take
// and give one message per column, and each kernel walks its own items (K1 flat over the degree groups, four columns per
// thread; K3 a grid-wide stride). Every node output is a strict
// left-to-right fold of its inputs with the own edge removed, step p through
// pairwise LUT p-1 indexed lut[state][next] (ops/lut_fold.py). The tables
// are not associative, so outputs share prefixes and no suffix: a degree-d
// check node makes (d-2)(d+3)/2 lookups, a variable node (d-1)(d+2)/2.
//
// What bounds the folds on an NVIDIA H100 80GB HBM3 (700 W): each lookup
// waits for the one before it, so a thread with one chain in flight leaves
// the shared-memory pipe idle. K1 with one column per thread ran at a third
// of its lookup bound (3.1476 ms against 0.9965 ms for a WLAN |T|=16 decode
// of batch 4096, 49 bodies); with four columns' folds unrolled side by
// side, 2.4400 ms (cli/kernel_times.py). The folds read one byte per
// lookup: a nibble-packed table, conflict-free, cost more extraction on every
// chain step than the conflicts of a byte table shared by the block; a copy
// of the tables per lane (LaneLuts in K1 and K3, lane_row below) removes the
// conflicts where shared memory has room for it (K1: 1.77 instead of 2.40 ms
// with every lookup so redirected).

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

// The row of b in a lane's copy of per-lane tables (K1's and K3's LaneLuts):
// lane + 128 b, where lane is 4 x the lane (< 128, so an OR). A pure asm,
// opaque to the compilers' reassociation, so the lookups that take the same
// b share it (equal calls still fold into one); left to them, each lookup
// took a second add.
__device__ __forceinline__ int lane_row(uint32_t lane, int b) {
  uint32_t r;
  asm("or.b32 %0, %1, %2;" : "=r"(r) : "r"(lane), "r"(uint32_t(b) << 7));
  return int(r);
}

#define IB_DEGREES_2_TO_16(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace ib_lut
