// K4: float (min-sum / BP) LDPC decoder with its message state in device
// memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/float_hbm.py:_build_float_hbm_kernel, for codes whose messages do
// not fit one CTA's shared memory (DVB-S2 N=64800: 2.07 MB of float32 views
// per codeword). It has K3's chassis (ib_lut_hbm.cu, hbm_tiles.cuh: per tile
// of bt codewords a done flag, a body count and the syndrome counts of its
// last body) and K2's node rules (float_groups.cuh): min-sum min1/min2 with
// the zero count and negative parity, BP box-plus by prefix/suffix, VN clamp
// +-150, decision unclamped, every add, subtract and multiply an explicitly
// rounded intrinsic. It has two paths, chosen by the wrapper from what it
// observes: the node-state path for min-sum where every check has degree 3
// to kStateMaxDegree, the view path for BP and for any other min-sum layout.
//
// Node-state path. Every min-sum check output is fixed by a few numbers:
// minsum_fold (D >= 3) writes out[j] = s_j * (|m_j| == min1 ? min2 : min1),
// s_j 0 when another input is zero and else +-1 from the parity of the other
// negative inputs. With two zero inputs every out[j] is +0; with one, every
// out[j] is +0 but at the zero input, the first slot that holds min1 (the
// argmin), where it is +-min2; with none, +-min2 at the argmin and +-min1
// elsewhere (a tie of min1 at another slot gets min2 == min1 there, the same
// bits). So a check keeps a record of 10 bytes a codeword: two float32
// magnitudes, `at_min` of its output at the argmin (min2, or 0 with two zero
// inputs) and `rest` of the others (min1, or 0 with a zero input), and a
// 16-bit code, the sign bit of each output (0 on a +0) and the argmin slot;
// any out[j] is the magnitude of its slot with its sign bit set, minsum_fold's
// bits, the sign of a zero included. The check folds its inputs one at a
// time (MinSumFold, minsum_fold's fminf/fmaxf order), so it holds none of
// them. A variable keeps its total T = ch + ((m0 + m1) + ...), vn_total's
// fold, and the view path's VN output clip(T - m_k) is rebuilt from T and
// the check's own previous output m_k. Nothing is rounded, dropped or
// reordered: outputs, unsat and iterations equal the view path's bit for bit.
//   state (device memory, each plane [slice][node][S]: a slice is S columns
//   of a tile, S a multiple of kVec dividing bt):
//     rest, at_min (4 B each) and the code (2 B) per check, one copy: the CN
//       pass reads a check's old record and writes its new one at the same
//       place, and no other pass reads it in between;
//     T and chs, the channel LLRs, 4 B each per variable;
//   CN pass of body i: per check, its old record and T of its variables
//     gathered; each input v->c = clip(T_v - c->v_old) (body 0 the raw
//     channel LLR, as the view path's seeded A; a degree-1 variable
//     clip(ch)); with early exit and i >= 1 the syndrome of those inputs,
//     summed in registers over a thread's checks of a slice; the new record;
//   VN pass: per variable, chs and the records of its checks gathered, each
//     c->v rebuilt, T written in vn_total's order;
//   the exit convention is the view path's (below): a tile that leaves after
//   body i skips the VN pass of body i + 1, so T still holds body i's
//   posterior, and the decision writes T at the natural variable index.
// Walk: each CN, VN and syndrome launch is a persistent grid that walks the
// slices one after another (a block's rows cover one slice, then the next;
// the whole card stays on one slice, or two at its edges, when the code's
// rows fill it), the VN pass backwards, so each pass starts on the slice
// the last one ended on. A CN pass gathers the T rows of its slice again and
// again (about 3.5 reads a row on DVB-S2) and a VN pass the records (7 a
// check); the slice is cut so that the live slice's records and totals stay
// in the 50 MB L2 and device memory sees each state byte about once a pass.
// Bytes a DVB-S2 body at batch 1024: CN reads 0.33 GB of records and 0.27 GB
// of T and writes 0.33 GB, VN reads 0.27 GB of chs and 0.33 GB of records
// and writes 0.27 GB of T: 1.79 GB, 0.54 ms at the data sheet's 3.35 TB/s
// (the view path: 3.98 GB, 1.19 ms). What bounds it on this card is L2, not
// device memory: the gathers go through L2 once an edge, 4 B of T an edge
// in the CN pass and 10 B of record an edge in the VN pass, 1.6 and 2.8 MB a
// DVB-S2 codeword a pass. Measured on an H100 80GB HBM3 at 700 W: a body
// takes 0.52 ms in the CN pass and 0.67 in the VN pass at batch 1024 (1.77
// and 1.29 TB/s of state bytes), and the same passes with the whole state
// held in L2 (batch 32) take 0.58 and 0.45 us a codeword, so the CN pass is
// bound by L2 and its own instructions, the VN pass by L2 plus the device
// memory reads it does not overlap; the view path took 0.67 and 0.75 ms. The
// streams (the CN pass's records, the VN pass's chs and T) are read and
// written evict-first, which kept more of the gathered state in L2 (a decode
// 61.4 -> 58.2 ms), and both passes are built for 4 blocks an SM.
//
// View path (BP; min-sum with a degree-2 check, which minsum_fold passes
// through raw, or a check wider than a code word holds): float32 views
// [tile][row][bt] (any multiple of 4 up to hbm_wide's kMaxTile), one launch
// per pass over all tiles (grid y = tile):
//   seed: CN view A <- channel LLR of each row's variable, channel plane, the
//     tile's state zeroed (padding columns hold 0 and take part in the exit
//     test);
//   per body i = 0 .. imax-2: CN pass A -> B[i % 2], with early exit and i >=
//     1 counting the syndrome of A per codeword in shared memory, added to
//     the tile's counts once per block; then the exit step for body i-1
//     (bodies run = i; the tile is done when none of its codewords has an
//     unsatisfied check); VN pass B[i % 2] -> A (the tile's unsat counts
//     zeroed);
//   after the last body, the syndrome of A alone and the exit step for body
//   imax-2 (without early exit, the only syndrome pass, which reports the
//   last body's counts);
//   imax <= 1 runs no body: the syndrome of the seeded A, and a zero B (the
//   caller's scratch);
//   decision ch + left-fold sum of B[(bodies - 1) % 2] at the natural
//   variable index; unsat and iters per codeword.
// A body reads and writes both views once, 4 x 226,799 x 4 B = 3.6 MB per
// DVB-S2 codeword plus the channel plane; BP adds two expf and two log1pf
// per box-plus, 3(d-2) box-plus per check. The CN and VN passes are wide
// (hbm_wide.cuh): a thread takes 4 columns of a node and moves them as one
// float4 per view row, every column's operations in the same order as the
// narrow rules. B is held twice: body i writes B[i % 2], so the CN pass of
// body i+1 does not overwrite the messages of body i that the decision of a
// tile leaving after body i reads.
//
// Exit convention (both paths): K2's and the plain decoder's, not the JAX
// kernel's. The JAX kernel tests the syndrome on the staged CN view of the
// next body, so a tile leaves one body late and reports one more iteration.
// Here the CN pass of body i+1 counts the syndrome of its inputs, the VN->CN
// messages of body i, and the exit step after it marks the tile done after
// body i. Outputs, unsat and iterations equal float_decode_tiled's (min-sum
// up to the sign of a zero, which minsum_fold makes +0 where the twin's sign
// product may give -0). Blocks of a finished tile return at once (a walking
// block skips its slices). Launches per decode, both paths: 3 imax with
// early exit (150 at i_max 50), 2 imax + 2 without, plus one per VN pass
// (and on the view path per CN pass) for a code with nodes above hbm_wide's
// split degree.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "float_groups.cuh"
#include "hbm_tiles.cuh"
#include "hbm_wide.cuh"

namespace {

using float_llr::kBP;
using float_llr::kMinSum;

using hbm_tiles::first_item;
using hbm_tiles::item_step;
using hbm_tiles::tile_done;
using hbm_tiles::view_base;
using hbm_wide::in_range;
using hbm_wide::kSplitDegree;
using hbm_wide::lane;
using hbm_wide::RowItems;

constexpr int kMaxDegree = 16;
constexpr int kVec = 4;  // floats per thread and view row

// The node-state path's record code, 16 bits a check: one sign bit an edge
// slot, then the argmin slot; so a check has at most 12 edges.
constexpr int kStateMaxDegree = 12;
constexpr int kArgminShift = kStateMaxDegree;
constexpr int kSlotBits = 4;  // vn_check = check << kSlotBits | slot
// Blocks an SM the node-state CN and VN passes are built for (at most 64
// registers a thread): the CN pass, which then spills a few, ran faster than
// at 93 registers and 2 blocks; the VN pass faster than built for 3 blocks
// or with no bound (40 registers).
constexpr int kCheckBlocks = 4;
constexpr int kVarBlocks = 4;

// The node-state path's device memory (null on the view path).
struct NodeState {
  float* rest;              // [n_slices, n_checks, slice] |out| off the argmin slot
  float* at_min;            // [n_slices, n_checks, slice] |out| at the argmin slot
  uint16_t* code;           // [n_slices, n_checks, slice] out signs, argmin
  float* total;             // [n_slices, n_vars, slice] T, group order
  float* chs;               // [n_slices, n_vars, slice] channel LLRs, group order
  const int32_t* cn_var;    // [n_edges] CN-view row -> variable (group order), ~v at degree 1
  const int32_t* vn_check;  // [n_edges] VN-view row -> check (group order) << kSlotBits | slot
  int slice;                // columns a slice: a multiple of kVec that divides bt; 0: views
};

struct Params {
  const float* llrs;         // [n_vars, batch]
  float* outputs;            // [n_vars, batch]
  int32_t* unsat_out;        // [batch]
  int32_t* iters_out;        // [batch]
  const int32_t* seed_var;   // [n_edges] variable of each CN-view row
  float_llr::Graph g;        // groups, routes, node order, bt
  float* A;                  // [n_tiles, n_edges, bt] CN view
  float* B;                  // [2, n_tiles, n_edges, bt] VN views of even and odd bodies
  float* chg;                // [n_tiles, n_vars, bt] channel LLRs, group order
  int32_t* unsat;            // [n_tiles, bt] syndrome counts of the tile's last body
  int32_t* state;            // [n_tiles, 2] done flag, bodies run
  size_t view_elems;         // n_tiles * n_edges * bt: the offset of B[1]
  int n_vars, n_checks, n_edges, batch;
  int d_c_max, d_v_max;
  int early_exit;
  NodeState st;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__global__ void __launch_bounds__(hbm_tiles::kThreads) seed_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  float* A = p.A + view_base(p, tile);
  float* chg = p.chg + size_t(tile) * p.n_vars * bt;
  for (int t = first_item(); t < p.n_edges * bt; t += item_step()) {
    const int r = t / bt, col = b0 + t - r * bt;
    A[t] = col < p.batch ? p.llrs[size_t(__ldg(&p.seed_var[r])) * p.batch + col] : 0.f;
  }
  for (int t = first_item(); t < p.n_vars * bt; t += item_step()) {
    const int r = t / bt, col = b0 + t - r * bt;
    chg[t] = col < p.batch ? p.llrs[size_t(__ldg(&p.g.node_var[r])) * p.batch + col] : 0.f;
  }
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < bt; c += blockDim.x) p.unsat[tile * bt + c] = 0;
    if (threadIdx.x < 2) p.state[2 * tile + threadIdx.x] = 0;
  }
}

// One check group of degree D, 4 columns per item: D float4 loads, the
// syndrome of the inputs (with `unsat`), the rule per column, D routed
// float4 stores.
template <int RULE, int D>
__device__ void cn_group(const float* __restrict__ src, float* __restrict__ dst,
                         const int32_t* __restrict__ route, int off, int n, int* unsat, int bt,
                         RowItems it) {
  for (int node = it.node; node < n; node += it.node_step) {
    const int c0 = it.c0;
    float4 in[D];
    int row[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      in[k] = load4(src + (off + k * n + node) * bt + c0);
      row[k] = __ldg(&route[off + k * n + node]);
    }
    if (unsat != nullptr) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        int parity = 0;
#pragma unroll
        for (int k = 0; k < D; ++k) parity ^= int(lane(in[k], j) < 0.f);
        if (parity) atomicAdd(&unsat[c0 + j], 1);
      }
    }
    float4 out[D];
    // BP above the split degree: the columns in a loop (hbm_wide.cuh).
#pragma unroll ((RULE == kBP && D > kSplitDegree) ? 1 : kVec)
    for (int j = 0; j < kVec; ++j) {
      float m[D], o[D];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = lane(in[k], j);
      if constexpr (RULE == kMinSum)
        float_llr::minsum_fold<D>(m, o);
      else
        float_llr::bp_fold<D>(m, o);
#pragma unroll
      for (int k = 0; k < D; ++k) lane(out[k], j) = o[k];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) store4(dst + row[k] * bt + c0, out[k]);
  }
}

// One variable group of degree D, 4 columns per item, with the channel rows;
// degree 1 forwards clip(ch).
template <int D>
__device__ void vn_group(const float* __restrict__ src, float* __restrict__ dst,
                         const float* __restrict__ chg, const int32_t* __restrict__ route,
                         int off, int n, int node_off, int bt, RowItems it) {
  for (int node = it.node; node < n; node += it.node_step) {
    const int c0 = it.c0;
    const float4 ch = load4(chg + (node_off + node) * bt + c0);
    if constexpr (D == 1) {
      float4 out;
#pragma unroll
      for (int j = 0; j < kVec; ++j) lane(out, j) = float_llr::clip_llr(lane(ch, j));
      store4(dst + __ldg(&route[off + node]) * bt + c0, out);
    } else {
      float4 in[D], out[D];
      int row[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        in[k] = load4(src + (off + k * n + node) * bt + c0);
        row[k] = __ldg(&route[off + k * n + node]);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float m[D];
#pragma unroll
        for (int k = 0; k < D; ++k) m[k] = lane(in[k], j);
        const float total = float_llr::vn_total<D>(lane(ch, j), m);
#pragma unroll
        for (int k = 0; k < D; ++k)
          lane(out[k], j) = float_llr::clip_llr(__fsub_rn(total, m[k]));
      }
#pragma unroll
      for (int k = 0; k < D; ++k) store4(dst + row[k] * bt + c0, out[k]);
    }
  }
}

// CN pass A -> B[half] over the groups of the kernel's degree range; with
// `count`, the syndrome of A is added to the tile's unsat counts.
template <int RULE, bool HI>
__global__ void __launch_bounds__(hbm_wide::kThreads) cn_kernel(Params p, int half, int count) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;  // uniform over the block
  extern __shared__ int u[];       // [bt] this block's counts
  if (count) {
    for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
    __syncthreads();
  }
  const float_llr::Graph& g = p.g;
  const RowItems it = hbm_wide::row_items<kVec>(bt);
  const float* src = p.A + view_base(p, tile);
  float* dst = p.B + half * p.view_elems + view_base(p, tile);
  for (int k = 0; k < g.n_cn_groups; ++k) {
    const int off = g.cn_groups[3 * k], n = g.cn_groups[3 * k + 1];
    const int d = g.cn_groups[3 * k + 2];
    if (!in_range<HI>(d)) continue;
#define K4_CN_CASE(D)                                                                      \
  case D:                                                                                  \
    cn_group<RULE, D>(src, dst, g.cn_route, off, n, count ? u : nullptr, bt, it);          \
    break;
    if constexpr (HI) {
      switch (d) {
        WIDE_DEGREES_HI(K4_CN_CASE)
        default:
          __trap();
      }
    } else {
      switch (d) {
        WIDE_DEGREES_LO(K4_CN_CASE)
        default:
          __trap();
      }
    }
#undef K4_CN_CASE
  }
  if (count) {
    __syncthreads();
    for (int c = threadIdx.x; c < bt; c += blockDim.x)
      if (u[c]) atomicAdd(&p.unsat[tile * bt + c], u[c]);
  }
}

// VN pass B[half] -> A over the groups of the kernel's degree range; zeroes
// the tile's unsat counts for the next count.
template <bool HI>
__global__ void __launch_bounds__(hbm_wide::kThreads) vn_kernel(Params p, int half) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) p.unsat[tile * bt + c] = 0;
  const float_llr::Graph& g = p.g;
  const RowItems it = hbm_wide::row_items<kVec>(bt);
  const float* src = p.B + half * p.view_elems + view_base(p, tile);
  float* dst = p.A + view_base(p, tile);
  const float* chg = p.chg + size_t(tile) * p.n_vars * bt;
  for (int k = 0; k < g.n_vn_groups; ++k) {
    const int off = g.vn_groups[4 * k], n = g.vn_groups[4 * k + 1];
    const int d = g.vn_groups[4 * k + 2], node_off = g.vn_groups[4 * k + 3];
    if (!in_range<HI>(d)) continue;
#define K4_VN_CASE(D)                                                                      \
  case D:                                                                                  \
    vn_group<D>(src, dst, chg, g.vn_route, off, n, node_off, bt, it);                      \
    break;
    if constexpr (HI) {
      switch (d) {
        WIDE_DEGREES_HI(K4_VN_CASE)
        default:
          __trap();
      }
    } else {
      switch (d) {
        K4_VN_CASE(1)
        WIDE_DEGREES_LO(K4_VN_CASE)
        default:
          __trap();
      }
    }
#undef K4_VN_CASE
  }
}

// Syndrome of A, counted per codeword in shared memory, then added to the
// tile's counts: after the last body, or of the seeded view when no body runs.
__global__ void __launch_bounds__(hbm_tiles::kThreads) syndrome_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;
  extern __shared__ int u[];  // [bt] this block's counts
  for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
  __syncthreads();
  float_llr::syndrome_pass(p.g, p.A + view_base(p, tile), u, first_item(), item_step());
  __syncthreads();
  for (int c = threadIdx.x; c < bt; c += blockDim.x)
    if (u[c]) atomicAdd(&p.unsat[tile * bt + c], u[c]);
}

// Decision from B[(bodies - 1) % 2], the CN->VN messages of the tile's last
// body (B[1], zero, when no body ran).
__global__ void __launch_bounds__(hbm_tiles::kThreads) decide_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  const int bodies = p.state[2 * tile + 1];
  const float* B = p.B + ((bodies + 1) & 1) * p.view_elems + view_base(p, tile);
  float_llr::decide_pass(p.g, B, p.chg + size_t(tile) * p.n_vars * bt, p.outputs, b0, p.batch,
                         first_item(), item_step());
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) {
      if (b0 + c >= p.batch) continue;
      p.unsat_out[b0 + c] = p.unsat[tile * bt + c];
      p.iters_out[b0 + c] = bodies;
    }
}

// -- the node-state path ------------------------------------------------------

// A stream read once in the launch: evict-first in L2, and coherent, so the
// thread may overwrite it later in the launch.
__device__ __forceinline__ float4 load4_stream(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

// A stream written once and not read again in the launch (evict-first).
__device__ __forceinline__ void store4_stream(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// The 16-bit record codes of 4 columns, held as two words: code j of them
// (j a compile-time constant after unrolling), and the words of 4 codes.
__device__ __forceinline__ uint32_t code_of(uint2 v, int j) {
  return ((j < 2 ? v.x : v.y) >> (16 * (j & 1))) & 0xffffu;
}

__device__ __forceinline__ uint2 code_words(const uint32_t (&c)[kVec]) {
  return make_uint2(c[0] | c[1] << 16, c[2] | c[3] << 16);
}

// The output of edge slot `slot` rebuilt from its check's record (see
// MinSumFold::record): the argmin's magnitude at the argmin slot, the
// others' elsewhere, with the slot's sign bit; the bits of minsum_fold's
// product s_j * mag_j.
__device__ __forceinline__ float message(uint32_t code, int slot, float rest, float at_min) {
  const float mag = int(code >> kArgminShift) == slot ? at_min : rest;
  return __uint_as_float(__float_as_uint(mag) | (code >> slot & 1u) << 31);
}

// minsum_fold's arithmetic (float_groups.cuh, D >= 3) folded one input at a
// time: min1 and min2 in its order of fminf/fmaxf, the first slot that holds
// min1 (argmin), the zero count and the sign of each input.
struct MinSumFold {
  float min1, min2;
  int argmin, zeros;
  uint32_t signs;

  __device__ __forceinline__ void first(float m) {
    min1 = fabsf(m);
    min2 = INFINITY;
    argmin = 0;
    zeros = m == 0.f;
    signs = uint32_t(m < 0.f);
  }
  __device__ __forceinline__ void add(int k, float m) {
    const float a = fabsf(m);
    min2 = fminf(min2, fmaxf(min1, a));
    if (a < min1) argmin = k;
    min1 = fminf(min1, a);
    zeros += m == 0.f;
    signs |= uint32_t(m < 0.f) << k;
  }
  // The parity of the negative inputs: 1 for an unsatisfied check.
  __device__ __forceinline__ int negs() const { return __popc(signs) & 1; }
  // The check's record, its outputs as minsum_fold writes them: every
  // out[j] is +0 when two inputs are zero; when one is, +0 except at that
  // input, which is the argmin (|0| == min1) and gets +-min2; else +-min2 at
  // the argmin and +-min1 elsewhere (a tie of min1 at another slot gets min2
  // == min1 there, the same bits). So `rest` is min1 or 0, `at_min` min2 or
  // 0, and the code holds the sign of each nonzero out[j] (negs ^ the sign
  // of m_j) and the argmin.
  template <int D>
  __device__ __forceinline__ void record(float& rest, float& at_min, uint32_t& code) const {
    const uint32_t out_signs = negs() ? signs ^ ((1u << D) - 1) : signs;
    rest = zeros == 0 ? min1 : 0.f;
    at_min = zeros < 2 ? min2 : 0.f;
    code = (zeros == 0 ? out_signs : zeros == 1 ? out_signs & 1u << argmin : 0u) |
           uint32_t(argmin) << kArgminShift;
  }
};

// A walking launch: `slice_blocks` blocks cover one slice's rows, and the
// grid's gridDim.x / slice_blocks groups of them take the slices in turn.
struct SliceWalk {
  int first, step;  // this block's first slice and its stride
  RowItems it;      // this thread's rows and columns within a slice
};

__device__ __forceinline__ SliceWalk slice_walk(int slice, int slice_blocks) {
  const int lanes = slice / kVec;  // threads per node row; blockDim.x is a multiple
  const int t = (blockIdx.x % slice_blocks) * blockDim.x + threadIdx.x;
  return {int(blockIdx.x / slice_blocks), int(gridDim.x / slice_blocks),
          {t / lanes, slice_blocks * int(blockDim.x / lanes), t % lanes * kVec}};
}

// One check group of degree D on slice planes, 4 columns a thread: each
// input rebuilt from the gathered T and the check's old record (body 0: the
// raw channel LLR) and folded as it comes; its syndrome added to `unsat`
// (the thread's own columns, in registers); with WRITE the new record in
// place.
template <int D, bool FIRST, bool WRITE>
__device__ __forceinline__ void state_cn_group(const NodeState& st, size_t cbase, size_t vbase,
                                               int off, int n, int rec0, int (&unsat)[kVec],
                                               RowItems it) {
  const int S = st.slice;
  for (int node = it.node; node < n; node += it.node_step) {
    const int c0 = it.c0;
    const size_t r = cbase + size_t(rec0 + node) * S + c0;
    float4 old_rest{}, old_at_min{};
    uint2 old{};
    if constexpr (!FIRST) {  // read once, then overwritten by this thread
      old_rest = load4_stream(st.rest + r);
      old_at_min = load4_stream(st.at_min + r);
      old = *reinterpret_cast<const uint2*>(st.code + r);
    }
    MinSumFold f[kVec];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int v = __ldg(&st.cn_var[off + k * n + node]);
      float4 in;
      if constexpr (FIRST) {
        in = load4(st.chs + vbase + size_t(v < 0 ? ~v : v) * S + c0);
      } else if (v < 0) {  // degree 1: the variable forwards clip(ch)
        in = load4(st.chs + vbase + size_t(~v) * S + c0);
#pragma unroll
        for (int j = 0; j < kVec; ++j) lane(in, j) = float_llr::clip_llr(lane(in, j));
      } else {
        in = load4(st.total + vbase + size_t(v) * S + c0);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          lane(in, j) = float_llr::clip_llr(__fsub_rn(
              lane(in, j), message(code_of(old, j), k, lane(old_rest, j), lane(old_at_min, j))));
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (k == 0)
          f[j].first(lane(in, j));
        else
          f[j].add(k, lane(in, j));
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) unsat[j] += f[j].negs();
    if constexpr (WRITE) {
      float4 rest, at_min;
      uint32_t codes[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j].record<D>(lane(rest, j), lane(at_min, j), codes[j]);
      store4_stream(st.rest + r, rest);
      store4_stream(st.at_min + r, at_min);
      *reinterpret_cast<uint2*>(st.code + r) = code_words(codes);
    }
  }
}

// The slices of a check walk: per slice, every check group; with `count` the
// syndrome per codeword, summed in each thread's registers over its rows of
// the slice, then in shared memory, added to the tile's counts once per
// slice and block.
template <bool FIRST, bool WRITE>
__device__ __forceinline__ void state_check_walk(const Params& p, int slice_blocks, int count) {
  extern __shared__ int u[];  // [slice] this block's counts
  const NodeState& st = p.st;
  const int S = st.slice, bt = p.g.bt, spt = bt / S;
  const int n_slices = (p.batch + bt - 1) / bt * spt;
  const SliceWalk w = slice_walk(S, slice_blocks);
  for (int s = w.first; s < n_slices; s += w.step) {
    const int tile = s / spt;
    if (tile_done(p, tile)) continue;  // uniform over the block
    if (count) {
      for (int c = threadIdx.x; c < S; c += blockDim.x) u[c] = 0;
      __syncthreads();
    }
    const size_t cbase = size_t(s) * p.n_checks * S, vbase = size_t(s) * p.n_vars * S;
    int unsat[kVec] = {};
    int rec0 = 0;
    for (int k = 0; k < p.g.n_cn_groups; ++k) {
      const int off = p.g.cn_groups[3 * k], n = p.g.cn_groups[3 * k + 1];
      const int d = p.g.cn_groups[3 * k + 2];
      switch (d) {
#define K4_STATE_CN_CASE(D)                                                                \
  case D:                                                                                  \
    state_cn_group<D, FIRST, WRITE>(st, cbase, vbase, off, n, rec0, unsat, w.it);           \
    break;
        K4_STATE_CN_CASE(3)
        K4_STATE_CN_CASE(4)
        K4_STATE_CN_CASE(5)
        K4_STATE_CN_CASE(6)
        K4_STATE_CN_CASE(7)
        K4_STATE_CN_CASE(8)
        K4_STATE_CN_CASE(9)
        K4_STATE_CN_CASE(10)
        K4_STATE_CN_CASE(11)
        K4_STATE_CN_CASE(12)
#undef K4_STATE_CN_CASE
        default:
          __trap();
      }
      rec0 += n;
    }
    if (count) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (unsat[j]) atomicAdd(&u[w.it.c0 + j], unsat[j]);
      __syncthreads();
      const int col0 = tile * bt + s % spt * S;
      for (int c = threadIdx.x; c < S; c += blockDim.x)
        if (u[c]) atomicAdd(&p.unsat[col0 + c], u[c]);
      __syncthreads();
    }
  }
}

// CN pass of the node-state path (FIRST: body 0, on the channel LLRs).
template <bool FIRST>
__global__ void __launch_bounds__(hbm_wide::kThreads, kCheckBlocks)
    state_cn_kernel(Params p, int slice_blocks, int count) {
  state_check_walk<FIRST, true>(p, slice_blocks, count);
}

// The syndrome of the inputs a CN pass would rebuild, after the last body
// (FIRST: of the channel LLRs, when no body runs).
template <bool FIRST>
__global__ void __launch_bounds__(hbm_wide::kThreads)
    state_syndrome_kernel(Params p, int slice_blocks) {
  state_check_walk<FIRST, false>(p, slice_blocks, 1);
}

// One variable group of degree D on slice planes, 4 columns a thread: chs
// and the records of its checks gathered, T = ch + ((m0 + m1) + ...)
// written.
template <int D>
__device__ __forceinline__ void state_vn_group(const NodeState& st, size_t cbase, size_t vbase,
                                               int off, int n, int node_off, RowItems it) {
  const int S = st.slice;
  for (int node = it.node; node < n; node += it.node_step) {
    const int c0 = it.c0;
    const size_t v = vbase + size_t(node_off + node) * S + c0;
    const float4 ch = load4_stream(st.chs + v);
    float4 sum;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int rc = __ldg(&st.vn_check[off + k * n + node]);
      const size_t r = cbase + size_t(rc >> kSlotBits) * S + c0;
      const int slot = rc & ((1 << kSlotBits) - 1);
      const uint2 codes = __ldg(reinterpret_cast<const uint2*>(st.code + r));
      const float4 rest = load4(st.rest + r), at_min = load4(st.at_min + r);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float m = message(code_of(codes, j), slot, lane(rest, j), lane(at_min, j));
        lane(sum, j) = k == 0 ? m : __fadd_rn(lane(sum, j), m);
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) lane(sum, j) = __fadd_rn(lane(ch, j), lane(sum, j));
    store4_stream(st.total + v, sum);
  }
}

// VN pass of the node-state path over the groups of its degree range,
// walking the slices backwards; zeroes the unsat counts of the live tiles.
template <bool HI>
__global__ void __launch_bounds__(hbm_wide::kThreads, kVarBlocks)
    state_vn_kernel(Params p, int slice_blocks) {
  const NodeState& st = p.st;
  const int S = st.slice, bt = p.g.bt, spt = bt / S;
  const int n_tiles = (p.batch + bt - 1) / bt, n_slices = n_tiles * spt;
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < n_tiles * bt; c += blockDim.x)
      if (!tile_done(p, c / bt)) p.unsat[c] = 0;
  const SliceWalk w = slice_walk(S, slice_blocks);
  const size_t check_plane = size_t(p.n_checks) * S, var_plane = size_t(p.n_vars) * S;
  for (int i = w.first; i < n_slices; i += w.step) {
    const int s = n_slices - 1 - i;
    if (tile_done(p, s / spt)) continue;
    const size_t cbase = size_t(s) * check_plane, vbase = size_t(s) * var_plane;
    for (int k = 0; k < p.g.n_vn_groups; ++k) {
      const int off = p.g.vn_groups[4 * k], n = p.g.vn_groups[4 * k + 1];
      const int d = p.g.vn_groups[4 * k + 2], node_off = p.g.vn_groups[4 * k + 3];
      if (!in_range<HI>(d)) continue;
#define K4_STATE_VN_CASE(D)                                                                \
  case D:                                                                                  \
    state_vn_group<D>(st, cbase, vbase, off, n, node_off, w.it);                           \
    break;
      if constexpr (HI) {
        switch (d) {
          WIDE_DEGREES_HI(K4_STATE_VN_CASE)
          default:
            __trap();
        }
      } else {
        switch (d) {
          K4_STATE_VN_CASE(1)
          WIDE_DEGREES_LO(K4_STATE_VN_CASE)
          default:
            __trap();
        }
      }
#undef K4_STATE_VN_CASE
    }
  }
}

// The items of one tile's slice planes of variables: t = (slice * n_vars +
// variable) * S + column, written as the variable and the tile's column.
__device__ __forceinline__ void var_item(int t, int n_vars, int S, int* var, int* col) {
  const int per_slice = n_vars * S;
  const int sl = t / per_slice, rem = t - sl * per_slice;
  *var = rem / S;
  *col = sl * S + rem - *var * S;
}

// chs <- the channel LLRs of each tile (0 in padding columns); with `totals`
// (no body runs) T <- ch + 0, the view path's decision over a zero B; the
// tile's state zeroed.
__global__ void __launch_bounds__(hbm_tiles::kThreads) state_seed_kernel(Params p, int totals) {
  const NodeState& st = p.st;
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  const size_t base = size_t(tile) * p.n_vars * bt;
  for (int t = first_item(); t < p.n_vars * bt; t += item_step()) {
    int v, col;
    var_item(t, p.n_vars, st.slice, &v, &col);
    const float x =
        b0 + col < p.batch ? p.llrs[size_t(__ldg(&p.g.node_var[v])) * p.batch + b0 + col] : 0.f;
    st.chs[base + t] = x;
    if (totals) st.total[base + t] = __fadd_rn(x, 0.f);
  }
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < bt; c += blockDim.x) p.unsat[tile * bt + c] = 0;
    if (threadIdx.x < 2) p.state[2 * tile + threadIdx.x] = 0;
  }
}

// Decision: T of the tile's last body at the natural variable index; unsat
// and iters per codeword.
__global__ void __launch_bounds__(hbm_tiles::kThreads) state_decide_kernel(Params p) {
  const NodeState& st = p.st;
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  const float* T = st.total + size_t(tile) * p.n_vars * bt;
  for (int t = first_item(); t < p.n_vars * bt; t += item_step()) {
    int v, col;
    var_item(t, p.n_vars, st.slice, &v, &col);
    if (b0 + col < p.batch)
      p.outputs[size_t(__ldg(&p.g.node_var[v])) * p.batch + b0 + col] = T[t];
  }
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) {
      if (b0 + c >= p.batch) continue;
      p.unsat_out[b0 + c] = p.unsat[tile * bt + c];
      p.iters_out[b0 + c] = p.state[2 * tile + 1];
    }
}

// A walking launch as launched: `slice_blocks` blocks of whole node rows a
// slice, times the slices taken at once.
struct WalkShape {
  int blocks, threads, slice_blocks;
};

// The shape of a walking launch of `kernel` over `rows` node rows a slice:
// as many blocks as the card holds at once for it, in groups that each
// cover a slice's rows, no more groups than slices.
template <class Kernel>
inline cudaError_t walk_shape(Kernel kernel, int slice, int smem, int rows, int n_slices, int sms,
                              WalkShape* shape) {
  const int lanes = slice / kVec, rows_per_block = hbm_wide::kThreads / lanes;
  const int threads = rows_per_block * lanes;
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int needed = (rows + rows_per_block - 1) / rows_per_block;
  const int slice_blocks = needed < resident ? needed : resident;
  int groups = resident / slice_blocks;
  if (groups > n_slices) groups = n_slices;
  *shape = WalkShape{slice_blocks * groups, threads, slice_blocks};
  return cudaSuccess;
}

int decode_state(const Params& p, int imax, cudaStream_t s) {
  const int bt = p.g.bt, S = p.st.slice, n_tiles = (p.batch + bt - 1) / bt;
  const int n_slices = n_tiles * (bt / S);
  const bool vn_hi = p.d_v_max > kSplitDegree;
  const int syn_smem = sizeof(int) * S;
  int sms = 0;
  WalkShape cn0, cn, syn, vn_lo, vn_hi_shape;
  cudaError_t err = hbm_tiles::sm_count(&sms);
  if (err == cudaSuccess)
    err = walk_shape(state_cn_kernel<true>, S, syn_smem, p.n_checks, n_slices, sms, &cn0);
  if (err == cudaSuccess)
    err = walk_shape(state_cn_kernel<false>, S, syn_smem, p.n_checks, n_slices, sms, &cn);
  if (err == cudaSuccess)
    err = imax <= 1 ? walk_shape(state_syndrome_kernel<true>, S, syn_smem, p.n_checks, n_slices,
                                 sms, &syn)
                    : walk_shape(state_syndrome_kernel<false>, S, syn_smem, p.n_checks,
                                 n_slices, sms, &syn);
  if (err == cudaSuccess)
    err = walk_shape(state_vn_kernel<false>, S, 0, p.n_vars, n_slices, sms, &vn_lo);
  if (err == cudaSuccess && vn_hi)
    err = walk_shape(state_vn_kernel<true>, S, 0, p.n_vars, n_slices, sms, &vn_hi_shape);
  if (err != cudaSuccess) return int(err);
  const dim3 var_grid = hbm_tiles::pass_grid(p.n_vars * bt, n_tiles, sms);
  const auto vn = [&] {
    state_vn_kernel<false><<<vn_lo.blocks, vn_lo.threads, 0, s>>>(p, vn_lo.slice_blocks);
    if (vn_hi)
      state_vn_kernel<true><<<vn_hi_shape.blocks, vn_hi_shape.threads, 0, s>>>(
          p, vn_hi_shape.slice_blocks);
  };

  HBM_LAUNCH(state_seed_kernel<<<var_grid, hbm_tiles::kThreads, 0, s>>>(p, imax <= 1));
  if (imax <= 1)
    HBM_LAUNCH(state_syndrome_kernel<true><<<syn.blocks, syn.threads, syn_smem, s>>>(
        p, syn.slice_blocks));
  for (int i = 0; i < imax - 1; ++i) {
    const int count = p.early_exit && i >= 1;
    if (i == 0)
      HBM_LAUNCH(state_cn_kernel<true><<<cn0.blocks, cn0.threads, syn_smem, s>>>(
          p, cn0.slice_blocks, 0));
    else
      HBM_LAUNCH(state_cn_kernel<false><<<cn.blocks, cn.threads, syn_smem, s>>>(
          p, cn.slice_blocks, count));
    if (count) HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, i - 1));
    HBM_LAUNCH(vn());
  }
  if (imax >= 2) {
    HBM_LAUNCH(state_syndrome_kernel<false><<<syn.blocks, syn.threads, syn_smem, s>>>(
        p, syn.slice_blocks));
    HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, imax - 2));
  }
  HBM_LAUNCH(state_decide_kernel<<<var_grid, hbm_tiles::kThreads, 0, s>>>(p));
  return int(cudaSuccess);
}

template <int RULE>
int decode(const Params& p, int imax, cudaStream_t s) {
  const int bt = p.g.bt, n_tiles = (p.batch + bt - 1) / bt, n_checks = p.n_checks;
  const bool cn_hi = p.d_c_max > kSplitDegree, vn_hi = p.d_v_max > kSplitDegree;
  const int syn_smem = sizeof(int) * bt;
  int sms = 0;
  hbm_wide::PassShape cn_lo, cn_hi_shape, vn_lo, vn_hi_shape;
  cudaError_t err = hbm_tiles::sm_count(&sms);
  if (err == cudaSuccess)
    err = hbm_wide::pass_shape(cn_kernel<RULE, false>, kVec, bt, syn_smem, n_checks, n_tiles,
                               sms, &cn_lo);
  if (err == cudaSuccess && cn_hi)
    err = hbm_wide::pass_shape(cn_kernel<RULE, true>, kVec, bt, syn_smem, n_checks, n_tiles,
                               sms, &cn_hi_shape);
  if (err == cudaSuccess)
    err = hbm_wide::pass_shape(vn_kernel<false>, kVec, bt, 0, p.n_vars, n_tiles, sms, &vn_lo);
  if (err == cudaSuccess && vn_hi)
    err = hbm_wide::pass_shape(vn_kernel<true>, kVec, bt, 0, p.n_vars, n_tiles, sms,
                               &vn_hi_shape);
  if (err != cudaSuccess) return int(err);
  const dim3 seed_grid = hbm_tiles::pass_grid(p.n_edges * bt, n_tiles, sms);
  const dim3 syn_grid = hbm_tiles::pass_grid(n_checks * bt, n_tiles, sms);
  const dim3 decide_grid = hbm_tiles::pass_grid(p.n_vars * bt, n_tiles, sms);
  const auto cn = [&](int half, int count) {
    cn_kernel<RULE, false><<<cn_lo.grid, cn_lo.threads, syn_smem, s>>>(p, half, count);
    if (cn_hi)
      cn_kernel<RULE, true><<<cn_hi_shape.grid, cn_hi_shape.threads, syn_smem, s>>>(p, half,
                                                                                   count);
  };
  const auto vn = [&](int half) {
    vn_kernel<false><<<vn_lo.grid, vn_lo.threads, 0, s>>>(p, half);
    if (vn_hi) vn_kernel<true><<<vn_hi_shape.grid, vn_hi_shape.threads, 0, s>>>(p, half);
  };
  const auto syndrome = [&] {
    syndrome_kernel<<<syn_grid, hbm_tiles::kThreads, syn_smem, s>>>(p);
  };

  HBM_LAUNCH(seed_kernel<<<seed_grid, hbm_tiles::kThreads, 0, s>>>(p));
  if (imax <= 1) HBM_LAUNCH(syndrome());
  for (int i = 0; i < imax - 1; ++i) {
    const int count = p.early_exit && i >= 1;
    HBM_LAUNCH(cn(i & 1, count));
    if (count) HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, i - 1));
    HBM_LAUNCH(vn(i & 1));
  }
  if (imax >= 2) {
    HBM_LAUNCH(syndrome());
    HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, imax - 2));
  }
  HBM_LAUNCH(decide_kernel<<<decide_grid, hbm_tiles::kThreads, 0, s>>>(p));
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt` (a multiple of kVec, at most
// hbm_wide's kMaxTile) on `stream` with the min-sum (rule 0) or BP (rule 1)
// check update. `slice` > 0 takes the node-state path (min-sum, check
// degrees 3 .. kStateMaxDegree, `slice` a multiple of kVec dividing bt):
// rest, at_min, code, total and chs are the caller's scratch (see NodeState),
// cn_var and vn_check its index arrays, and A, B and chg are not touched.
// `slice` 0 takes the view path: A, B (two views), chg are the caller's
// scratch (B zeroed when imax <= 1). unsat and state are the caller's
// scratch on both. Returns the first cudaError_t of the launches.
int float_hbm_decode(int rule, const float* llrs, float* outputs, int32_t* unsat_out,
                     int32_t* iters_out, const int32_t* seed_var, const int32_t* node_var,
                     const int32_t* cn_route, const int32_t* vn_route,
                     const int32_t* cn_groups, const int32_t* vn_groups, float* A, float* B,
                     float* chg, int32_t* unsat, int32_t* state, float* rest, float* at_min,
                     uint16_t* code, float* total, float* chs, const int32_t* cn_var,
                     const int32_t* vn_check, int n_cn_groups, int n_vn_groups, int n_vars,
                     int n_checks, int n_edges, int batch, int bt, int slice, int d_c_max,
                     int d_v_max, int imax, int early_exit, void* stream) {
  if (!hbm_wide::takes_tile(bt, kVec)) return int(cudaErrorInvalidValue);
  if (slice != 0 && (rule != kMinSum || slice % kVec != 0 || slice < 0 || bt % slice != 0 ||
                     d_c_max > kStateMaxDegree))
    return int(cudaErrorInvalidValue);
  const float_llr::Graph g{cn_groups,   vn_groups,   cn_route, vn_route,
                           node_var,    n_cn_groups, n_vn_groups, bt};
  const int n_tiles = (batch + bt - 1) / bt;
  const NodeState st{rest, at_min, code, total, chs, cn_var, vn_check, slice};
  const Params p{llrs,     outputs, unsat_out, iters_out, seed_var, g,
                 A,        B,       chg,       unsat,     state,
                 size_t(n_tiles) * n_edges * bt, n_vars, n_checks, n_edges, batch,
                 d_c_max,  d_v_max, early_exit, st};
  const auto s = static_cast<cudaStream_t>(stream);
  if (slice != 0) return decode_state(p, imax, s);
  if (rule == kMinSum) return decode<kMinSum>(p, imax, s);
  if (rule == kBP) return decode<kBP>(p, imax, s);
  return int(cudaErrorInvalidValue);
}

int float_hbm_max_degree() { return kMaxDegree; }
int float_hbm_vec() { return kVec; }
int float_hbm_max_tile() { return hbm_wide::kMaxTile; }
int float_hbm_state_max_degree() { return kStateMaxDegree; }

const char* float_hbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
