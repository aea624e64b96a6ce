// K4: float (min-sum / BP) LDPC decoder with both message views in device
// memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/float_hbm.py:_build_float_hbm_kernel, for codes whose float32
// views do not fit one CTA's shared memory (DVB-S2 N=64800: 2.07 MB per
// codeword). It has K3's chassis (ib_lut_hbm.cu) with float32 views
// [tile][row][bt] (bt = 128 by default; any multiple of 4 up to hbm_wide's
// kMaxTile) and K2's node rules (float_groups.cuh): min-sum min1/min2
// with the zero count and negative parity, BP box-plus by prefix/suffix, VN
// clamp +-150, decision unclamped, every add, subtract and multiply an
// explicitly rounded intrinsic.
//
// Exit convention: K2's and the plain decoder's, not the JAX kernel's. The
// JAX kernel tests the syndrome on the staged CN view of the next body, so a
// tile leaves one body late and reports one more iteration. Here the CN pass
// of body i+1 counts the syndrome of its inputs, the VN->CN messages of body
// i, and the exit step after it marks the tile done after body i: the tile
// leaves right after the body whose VN->CN messages satisfy every check.
// The CN->VN view B is held twice: body i writes B[i % 2], so the CN pass of
// body i+1 does not overwrite the messages of body i that the decision of a
// tile leaving after body i reads. Outputs, unsat and iterations equal
// float_decode_tiled's.
//
// Per decode, every pass one launch over all tiles (grid y = tile), all
// enqueued on one stream with no host sync:
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
// Blocks of a finished tile return at once. Launches per decode: 3 imax with
// early exit (150 at i_max 50), 2 imax + 2 without, plus one per CN or VN
// pass for a code with nodes above hbm_wide's split degree.
//
// What bounds it on this card (counts from shapes, not measurements): a body
// reads and writes both views once, 4 x 226,799 x 4 B = 3.6 MB per DVB-S2
// codeword, 3.7 GB per body at batch 1024: device-memory bandwidth bounds
// min-sum, at about 1.1 ms per body at the data sheet's 3.35 TB/s; BP adds
// two expf and two log1pf per box-plus, 3(d-2) box-plus per check. So the
// syndrome rides in the CN pass (4 view passes per body, not 5) and the CN
// and VN passes are wide (hbm_wide.cuh): a thread takes 4 columns of a node
// and moves them as one float4 per view row (a warp a whole 512-byte row at
// the default tile of 128), with
// every column's operations in the same order as the narrow rules. The
// second B costs 929 MB of memory at batch 1024, no traffic. The seed, the
// syndrome-only pass and the decision run once per decode and stay one
// float per thread.

#include <cuda_runtime.h>

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
  int n_vars, n_edges, batch;
  int d_c_max, d_v_max;
  int early_exit;
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

template <int RULE>
int decode(const Params& p, int n_checks, int imax, cudaStream_t s) {
  const int bt = p.g.bt, n_tiles = (p.batch + bt - 1) / bt;
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
// hbm_wide's kMaxTile) on `stream` with the
// min-sum (rule 0) or BP (rule 1) check update; A, B (two views), chg, unsat
// and state are the caller's scratch (see Params; B zeroed when imax <= 1).
// Returns the first cudaError_t of the launches.
int float_hbm_decode(int rule, const float* llrs, float* outputs, int32_t* unsat_out,
                     int32_t* iters_out, const int32_t* seed_var, const int32_t* node_var,
                     const int32_t* cn_route, const int32_t* vn_route,
                     const int32_t* cn_groups, const int32_t* vn_groups, float* A, float* B,
                     float* chg, int32_t* unsat, int32_t* state, int n_cn_groups,
                     int n_vn_groups, int n_vars, int n_checks, int n_edges, int batch,
                     int bt, int d_c_max, int d_v_max, int imax, int early_exit,
                     void* stream) {
  if (!hbm_wide::takes_tile(bt, kVec)) return int(cudaErrorInvalidValue);
  const float_llr::Graph g{cn_groups,   vn_groups,   cn_route, vn_route,
                           node_var,    n_cn_groups, n_vn_groups, bt};
  const int n_tiles = (batch + bt - 1) / bt;
  const Params p{llrs,     outputs, unsat_out, iters_out, seed_var, g,
                 A,        B,       chg,       unsat,     state,
                 size_t(n_tiles) * n_edges * bt, n_vars, n_edges, batch,
                 d_c_max,  d_v_max, early_exit};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rule == kMinSum) return decode<kMinSum>(p, n_checks, imax, s);
  if (rule == kBP) return decode<kBP>(p, n_checks, imax, s);
  return int(cudaErrorInvalidValue);
}

int float_hbm_max_degree() { return kMaxDegree; }
int float_hbm_vec() { return kVec; }
int float_hbm_max_tile() { return hbm_wide::kMaxTile; }

const char* float_hbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
