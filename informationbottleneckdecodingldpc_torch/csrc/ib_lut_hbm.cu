// K3: IB lookup-table LDPC decoder with both message views in device memory,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/ib_lut_hbm.py:_build_hbm_kernel. It computes what that kernel and
// the plain decoder compute, bit for bit under the same tiles, for codes
// whose views do not fit one CTA's shared memory (DVB-S2 N=64800: 2 x 226,799
// + 64,800 bytes per codeword against K1's 227 KB). The TPU kernel's DMA
// chassis (chunk staging, scatter pieces, XLA-applied seed/unperm plans) is
// not carried over: on Hopper a route is an int32 row index and a routed
// write is a plain store.
//
// Layout: the views are uint8 [tile][row][bt] in device memory (bt = 128
// codewords by default; any multiple of 8 up to hbm_wide's kMaxTile), so a
// tile's slab is indexed as K1 indexes shared memory and the routed writes
// of one row are bt contiguous bytes; the channel clusters are converted
// once to a uint8 [tile][var][bt] plane. The folds are K1's
// (ib_lut_groups.cuh cn_fold / vn_fold).
//
// Per decode, every pass one launch over all tiles (grid y = tile), all
// enqueued on one stream with no host sync:
//   seed: CN view <- channel cluster of each row's variable, channel plane,
//     the tile's state zeroed (padding columns of the last tile hold 0 and
//     take part in its exit test, as in the plain twin);
//   iteration-0 CN pass with the iteration-0 tables (stride Tch) and
//   matching_cn[0], routed on write into the VN view;
//   per body i = 0 .. imax-2:
//     VN pass with vn_first[i]/vn_rest[i] and matching_vn[i] (degree-1 nodes
//       forward the channel, unaligned), the tile's unsat counts zeroed;
//     CN pass with cn_rest[i] and matching_cn[i+1]; the syndrome of its
//       inputs (hard bit t < T/2) counted per codeword in shared memory and
//       added to the tile's counts once per block;
//     exit: bodies run = i+1; with early exit the tile is done when no
//       codeword of it has an unsatisfied check (the launch boundary makes
//       the sum complete);
//   decision with the VN tables of each tile's own iteration count, written
//   to the natural variable order; unsat (1 when no body ran) and iters.
// Blocks of a finished tile return at once. Launches per decode: 3 imax - 1
// (149 at i_max 50), plus one per CN or VN pass for a code with nodes above
// hbm_wide's split degree (WLAN's degree-11 variable nodes) or whose tables
// are too large to copy per lane (|T| = 32).
//
// What bounds it on this card (counts from shapes, not measurements): each
// body reads and writes both byte views once and reads the channel plane,
// 4 x 226,799 + 64,800 B per DVB-S2 codeword, 995 MB per body at batch 1024,
// and one 128-codeword tile's two views (58 MB) exceed the 50 MB L2, so
// device-memory bandwidth bounds it: 0.297 ms per body at the data sheet's
// 3.35 TB/s. Its table lookups come next: about 1.9 M per codeword and body,
// 0.23 ms per body at one shared-memory load per lane and clock, twice that
// when two lanes of a warp meet in a bank, as random bytes of a 256-byte
// table (|T| = 16: 64 words over 32 banks) mostly do. So:
// - the CN and VN passes are wide (hbm_wide.cuh): a thread takes kVec = 8
//   columns of a node (80 registers; 16 took 128 and ran 7% slower, 4 ran 6%
//   slower on the H100), loads each input row with one 8-byte vector load,
//   unpacks the bytes in registers for the folds, and stores each routed
//   output row with one 8-byte store; a route is read once per 8 columns;
// - the folds' lookups stay direct byte-table loads from shared memory on
//   CUDA cores, from a copy of the pairwise tables per lane (LaneLuts, K5b's
//   conflict-free layout) for nodes up to the split degree, 64 KB per block
//   at |T| = 16. Nodes above the split degree, or every node when the copies
//   do not fit (|T| = 32), run in a general kernel at 4 bytes per access with
//   one copy of the tables per block (Luts);
// - the seed and the decision touch natural-order [n_vars, batch] rows whose
//   alignment follows the batch; they run once per decode and stay one byte
//   per thread.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hbm_tiles.cuh"
#include "hbm_wide.cuh"
#include "ib_lut_groups.cuh"

namespace {

using ib_lut::Luts;

using hbm_tiles::first_item;
using hbm_tiles::item_step;
using hbm_tiles::tile_done;
using hbm_tiles::view_base;
using hbm_wide::Bytes;
using hbm_wide::kSplitDegree;
using hbm_wide::RowItems;

constexpr int kMaxDegree = 16;
constexpr int kVec = 8;         // bytes per access of the per-lane kernels
constexpr int kGeneralVec = 4;  // bytes per access of the general kernels
// The per-lane copies are used up to this size, so that two blocks fit an SM.
constexpr int kMaxLaneTableBytes = 96 * 1024;
// LUT slots of nodes up to the split degree: a CN fold of degree d takes
// LUTs 0 .. d-3, a VN fold LUTs 0 .. d-1.
constexpr int kLaneCnSlots = kSplitDegree - 2;
constexpr int kLaneVnSlots = kSplitDegree;

// Bytes per access of a pass kernel: the per-lane one (LANES) or the general.
template <bool LANES>
constexpr int kPassVec = LANES ? kVec : kGeneralVec;

struct Params {
  const int32_t* clusters;  // [n_vars, batch]
  int32_t* outputs;         // [n_vars, batch]
  int32_t* unsat_out;       // [batch]
  int32_t* iters_out;       // [batch]
  const uint8_t* cn_tab;    // [i_max, n_cn_slots, slot]: CN LUTs per DE iteration
  const uint8_t* vn_tab;    // [i_max, n_vn_slots, slot]: vn_first, vn_rest...
  const uint8_t* match_cn;  // [i_max, d_c_max, T]
  const uint8_t* match_vn;  // [i_max, d_v_max, T]
  const int32_t* seed_var;  // [n_edges] variable of each CN-view row
  ib_lut::Graph g;          // groups, routes, node order, bt, T
  uint8_t* A;               // [n_tiles, n_edges, bt] CN view
  uint8_t* B;               // [n_tiles, n_edges, bt] VN view
  uint8_t* chg;             // [n_tiles, n_vars, bt] channel clusters, group order
  int32_t* unsat;           // [n_tiles, bt] syndrome counts of the tile's last body
  int32_t* state;           // [n_tiles, 2] done flag, bodies run
  int n_vars, n_edges, batch;
  int t_channel, n_cn_slots, n_vn_slots, slot, d_c_max, d_v_max;
  int early_exit;
};

// Pairwise LUTs of one pass with a copy per lane, the layout of K5b's
// lookup2d_lanes (peaks.cu): lane l's copy of entry x of slot s is byte s % 4
// of word ((s / 4) * slot + x) * 32 + l, so each lane reads only its own bank.
struct LaneLuts {
  const uint8_t* base;  // the block's copies + 4 * lane
  int slot;
  int stride;
  __device__ __forceinline__ uint8_t operator()(int l, int a, int b) const {
    return base[(((l >> 2) * slot + a * stride + b) << 7) + (l & 3)];
  }
};

// Bytes of the per-lane copies of `slots` LUTs of `slot` bytes.
__host__ __device__ __forceinline__ int lane_table_bytes(int slots, int slot) {
  return (slots + 3) / 4 * slot * 128;
}

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                                      int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = __ldg(&src[t]);
}

// The per-lane copies of `slots` LUTs of `slot` bytes at `src`: a thread packs
// the four slots' bytes of one entry into a word and stores it for four
// lanes with one 16-byte store, a warp 32 lanes' words of one entry.
__device__ __forceinline__ void stage_lanes(uint8_t* dst, const uint8_t* __restrict__ src,
                                            int slots, int slot) {
  const int words = (slots + 3) / 4 * slot;
  for (int i = threadIdx.x; i < 8 * words; i += blockDim.x) {
    const int w = i >> 3, grp = w / slot, x = w - grp * slot;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * grp + b < slots) v |= uint32_t(__ldg(&src[(4 * grp + b) * slot + x])) << (8 * b);
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(v, v, v, v);
  }
}

__global__ void __launch_bounds__(hbm_tiles::kThreads) seed_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  uint8_t* A = p.A + view_base(p, tile);
  uint8_t* chg = p.chg + size_t(tile) * p.n_vars * bt;
  for (int t = first_item(); t < p.n_edges * bt; t += item_step()) {
    const int r = t / bt, col = b0 + t - r * bt;
    A[t] = col < p.batch
               ? uint8_t(p.clusters[size_t(__ldg(&p.seed_var[r])) * p.batch + col])
               : uint8_t(0);
  }
  for (int t = first_item(); t < p.n_vars * bt; t += item_step()) {
    const int r = t / bt, col = b0 + t - r * bt;
    chg[t] = col < p.batch
                 ? uint8_t(p.clusters[size_t(__ldg(&p.g.node_var[r])) * p.batch + col])
                 : uint8_t(0);
  }
  if (blockIdx.x == 0 && threadIdx.x < 2) p.state[2 * tile + threadIdx.x] = 0;
}

// One check group of degree D, V columns per item: D vector loads, the
// syndrome of the inputs (with `unsat`), V column folds in registers, D
// routed vector stores.
template <int V, int D, class Lut>
__device__ void cn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, Lut lut,
                         const uint8_t* __restrict__ match_row,
                         const int32_t* __restrict__ route, int off, int n, int thresh,
                         int* unsat, int bt, RowItems it) {
  for (int node = it.node; node < n; node += it.node_step) {
    Bytes<V> in[D];
    int row[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      in[k].load(src + (off + k * n + node) * bt + it.c0);
      row[k] = __ldg(&route[off + k * n + node]);
    }
    if (unsat != nullptr) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        int parity = 0;
#pragma unroll
        for (int k = 0; k < D; ++k) parity ^= int(in[k].get(j) < thresh);
        if (parity) atomicAdd(&unsat[it.c0 + j], 1);
      }
    }
    Bytes<V> out[D];
#pragma unroll
    for (int k = 0; k < D; ++k) out[k].clear();
#pragma unroll
    for (int j = 0; j < V; ++j) {
      uint8_t m[D], o[D];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = in[k].get(j);
      ib_lut::cn_fold<D>(m, o, lut);
#pragma unroll
      for (int k = 0; k < D; ++k) out[k].put(j, match_row[o[k]]);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) out[k].store(dst + row[k] * bt + it.c0);
  }
}

// One variable group of degree D, V columns per item, with the channel rows.
template <int V, int D, class Lut>
__device__ void vn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                         const uint8_t* __restrict__ chg, Lut lut,
                         const uint8_t* __restrict__ match_row,
                         const int32_t* __restrict__ route, int off, int n, int node_off,
                         int bt, RowItems it) {
  for (int node = it.node; node < n; node += it.node_step) {
    Bytes<V> ch;
    ch.load(chg + (node_off + node) * bt + it.c0);
    if constexpr (D == 1) {
      // Degree-1 variable nodes forward the channel, unaligned.
      ch.store(dst + __ldg(&route[off + node]) * bt + it.c0);
    } else {
      Bytes<V> in[D], out[D];
      int row[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        in[k].load(src + (off + k * n + node) * bt + it.c0);
        row[k] = __ldg(&route[off + k * n + node]);
        out[k].clear();
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        uint8_t m[D], o[D];
#pragma unroll
        for (int k = 0; k < D; ++k) m[k] = in[k].get(j);
        ib_lut::vn_fold<D>(ch.get(j), m, o, lut);
#pragma unroll
        for (int k = 0; k < D; ++k) out[k].put(j, match_row[o[k]]);
      }
#pragma unroll
      for (int k = 0; k < D; ++k) out[k].store(dst + row[k] * bt + it.c0);
    }
  }
}

// Whether a pass kernel takes nodes of degree d: the per-lane kernel (LANES)
// those up to the split degree, the general kernel those from `min_degree`.
template <bool LANES>
__device__ __forceinline__ bool takes(int d, int min_degree) {
  return LANES ? d <= kSplitDegree : d >= min_degree;
}

// CN leave-one-out of every check group the kernel takes, src (CN view) ->
// dst (VN view), aligned by `match` (rows [d_c_max][T]); with `unsat`, the
// syndrome of the inputs is added per codeword column.
template <bool LANES, class Lut>
__device__ void cn_pass(const ib_lut::Graph& g, const uint8_t* src, uint8_t* dst, Lut lut,
                        const uint8_t* match, int* unsat, int min_degree) {
  constexpr int V = kPassVec<LANES>;
  const RowItems it = hbm_wide::row_items<V>(g.bt);
  for (int k = 0; k < g.n_cn_groups; ++k) {
    const int off = g.cn_groups[3 * k], n = g.cn_groups[3 * k + 1];
    const int d = g.cn_groups[3 * k + 2];
    if (!takes<LANES>(d, min_degree)) continue;
    const uint8_t* row = match + (d - 1) * g.t_decoder;
#define K3_CN_CASE(D)                                                                       \
  case D:                                                                                   \
    cn_group<V, D>(src, dst, lut, row, g.cn_route, off, n, g.t_decoder / 2, unsat, g.bt,    \
                   it);                                                                     \
    break;
    if constexpr (LANES) {
      switch (d) {
        WIDE_DEGREES_LO(K3_CN_CASE)
        default:
          __trap();
      }
    } else {
      switch (d) {
        WIDE_DEGREES_LO(K3_CN_CASE)
        WIDE_DEGREES_HI(K3_CN_CASE)
        default:
          __trap();
      }
    }
#undef K3_CN_CASE
  }
}

// VN leave-one-out of every variable group the kernel takes, with the
// channel clusters `chg` ([n_vars][bt], group order), src (VN view) ->
// dst (CN view).
template <bool LANES, class Lut>
__device__ void vn_pass(const ib_lut::Graph& g, const uint8_t* src, uint8_t* dst,
                        const uint8_t* chg, Lut lut, const uint8_t* match, int min_degree) {
  constexpr int V = kPassVec<LANES>;
  const RowItems it = hbm_wide::row_items<V>(g.bt);
  for (int k = 0; k < g.n_vn_groups; ++k) {
    const int off = g.vn_groups[4 * k], n = g.vn_groups[4 * k + 1];
    const int d = g.vn_groups[4 * k + 2], node_off = g.vn_groups[4 * k + 3];
    if (!takes<LANES>(d, min_degree)) continue;
    const uint8_t* row = match + (d - 1) * g.t_decoder;
#define K3_VN_CASE(D)                                                                     \
  case D:                                                                                 \
    vn_group<V, D>(src, dst, chg, lut, row, g.vn_route, off, n, node_off, g.bt, it);      \
    break;
    if constexpr (LANES) {
      switch (d) {
        K3_VN_CASE(1)
        WIDE_DEGREES_LO(K3_VN_CASE)
        default:
          __trap();
      }
    } else {
      switch (d) {
        K3_VN_CASE(1)
        WIDE_DEGREES_LO(K3_VN_CASE)
        WIDE_DEGREES_HI(K3_VN_CASE)
        default:
          __trap();
      }
    }
#undef K3_VN_CASE
  }
}

// Shared memory of a CN pass: the block's counts, the tables (per lane or
// per block), the alignment rows.
__host__ __device__ __forceinline__ int cn_tables_bytes(bool lanes, int n_cn_slots, int slot) {
  return lanes ? lane_table_bytes(n_cn_slots < kLaneCnSlots ? n_cn_slots : kLaneCnSlots, slot)
               : n_cn_slots * slot;
}
__host__ __device__ __forceinline__ int vn_tables_bytes(bool lanes, int n_vn_slots, int slot) {
  return lanes ? lane_table_bytes(n_vn_slots < kLaneVnSlots ? n_vn_slots : kLaneVnSlots, slot)
               : n_vn_slots * slot;
}

// CN pass of DE iteration k (k = 0: the iteration-0 tables, rows of Tch),
// A -> B; with `count`, the syndrome of the inputs is added to the tile's
// unsat counts.
template <bool LANES>
__global__ void __launch_bounds__(hbm_wide::kThreads)
    cn_kernel(Params p, int k, int count, int min_degree) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;  // uniform over the block
  extern __shared__ __align__(16) uint8_t smem[];
  int* u = reinterpret_cast<int*>(smem);  // [bt] this block's counts
  uint8_t* TC = smem + sizeof(int) * bt;  // 16-byte aligned: bt is a multiple of 8
  uint8_t* MC = TC + cn_tables_bytes(LANES, p.n_cn_slots, p.slot);
  const uint8_t* tab = p.cn_tab + size_t(k) * p.n_cn_slots * p.slot;
  const int mc_stage = p.d_c_max * p.g.t_decoder;
  if constexpr (LANES)
    stage_lanes(TC, tab, p.n_cn_slots < kLaneCnSlots ? p.n_cn_slots : kLaneCnSlots, p.slot);
  else
    stage(TC, tab, p.n_cn_slots * p.slot);
  stage(MC, p.match_cn + size_t(k) * mc_stage, mc_stage);
  if (count)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
  __syncthreads();
  const int stride = k == 0 ? p.t_channel : p.g.t_decoder;
  const uint8_t* src = p.A + view_base(p, tile);
  uint8_t* dst = p.B + view_base(p, tile);
  int* unsat = count ? u : nullptr;
  if constexpr (LANES)
    cn_pass<true>(p.g, src, dst, LaneLuts{TC + 4 * (threadIdx.x & 31), p.slot, stride}, MC,
                  unsat, min_degree);
  else
    cn_pass<false>(p.g, src, dst, Luts{TC, p.slot, stride}, MC, unsat, min_degree);
  if (count) {
    __syncthreads();
    for (int c = threadIdx.x; c < bt; c += blockDim.x)
      if (u[c]) atomicAdd(&p.unsat[tile * bt + c], u[c]);
  }
}

// VN pass of body i, B -> A; zeroes the tile's unsat counts for this body.
template <bool LANES>
__global__ void __launch_bounds__(hbm_wide::kThreads) vn_kernel(Params p, int i, int min_degree) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* TV = smem;
  uint8_t* MV = TV + vn_tables_bytes(LANES, p.n_vn_slots, p.slot);
  const uint8_t* tab = p.vn_tab + size_t(i) * p.n_vn_slots * p.slot;
  const int mv_stage = p.d_v_max * p.g.t_decoder;
  if constexpr (LANES)
    stage_lanes(TV, tab, p.n_vn_slots < kLaneVnSlots ? p.n_vn_slots : kLaneVnSlots, p.slot);
  else
    stage(TV, tab, p.n_vn_slots * p.slot);
  stage(MV, p.match_vn + size_t(i) * mv_stage, mv_stage);
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) p.unsat[tile * bt + c] = 0;
  __syncthreads();
  const uint8_t* src = p.B + view_base(p, tile);
  uint8_t* dst = p.A + view_base(p, tile);
  const uint8_t* chg = p.chg + size_t(tile) * p.n_vars * bt;
  if constexpr (LANES)
    vn_pass<true>(p.g, src, dst, chg, LaneLuts{TV + 4 * (threadIdx.x & 31), p.slot,
                  p.g.t_decoder}, MV, min_degree);
  else
    vn_pass<false>(p.g, src, dst, chg, Luts{TV, p.slot, p.g.t_decoder}, MV, min_degree);
}

// Decision with the VN tables of the tile's own iteration count.
__global__ void __launch_bounds__(hbm_tiles::kThreads) decide_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  const int iters = p.state[2 * tile + 1];
  extern __shared__ __align__(16) uint8_t smem[];
  const int vn_stage = p.n_vn_slots * p.slot;
  stage(smem, p.vn_tab + size_t(iters) * vn_stage, vn_stage);
  __syncthreads();
  ib_lut::decide_pass(p.g, p.B + view_base(p, tile), p.chg + size_t(tile) * p.n_vars * bt,
                      Luts{smem, p.slot, p.g.t_decoder}, p.outputs, b0, p.batch,
                      first_item(), item_step());
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) {
      if (b0 + c >= p.batch) continue;
      p.unsat_out[b0 + c] = iters == 0 ? 1 : p.unsat[tile * bt + c];
      p.iters_out[b0 + c] = iters;
    }
}

// One pass (CN or VN) as launched: the per-lane kernel for nodes up to the
// split degree when its tables fit, the general kernel for the rest.
struct PassLaunch {
  bool lanes, general;  // which of the two kernels run
  int min_degree;       // the general kernel's smallest degree
  int lanes_smem, general_smem;
  hbm_wide::PassShape lanes_shape, general_shape;
};

// `rows`: node rows per tile; `d_max`: the code's largest degree.
template <class LanesKernel, class GeneralKernel>
cudaError_t plan_pass(LanesKernel lanes_kernel, GeneralKernel general_kernel, int bt, int rows,
                      int n_tiles, int sms, int d_max, int lanes_tables, int general_tables,
                      int extra, int min_general, PassLaunch* out) {
  PassLaunch& pl = *out;
  pl.lanes = lanes_tables <= kMaxLaneTableBytes;
  pl.general = !pl.lanes || d_max > kSplitDegree;
  pl.min_degree = pl.lanes ? kSplitDegree + 1 : min_general;
  pl.lanes_smem = extra + lanes_tables;
  pl.general_smem = extra + general_tables;
  cudaError_t err = cudaSuccess;
  if (pl.lanes)
    err = hbm_wide::pass_shape(lanes_kernel, kVec, bt, pl.lanes_smem, rows, n_tiles, sms,
                               &pl.lanes_shape);
  if (err == cudaSuccess && pl.general)
    err = hbm_wide::pass_shape(general_kernel, kGeneralVec, bt, pl.general_smem, rows, n_tiles,
                               sms, &pl.general_shape);
  return err;
}

int decode(const Params& p, int n_checks, int imax, cudaStream_t s) {
  const int bt = p.g.bt, n_tiles = (p.batch + bt - 1) / bt;
  const int cn_match = p.d_c_max * p.g.t_decoder, vn_match = p.d_v_max * p.g.t_decoder;
  // Tables of one pass: a few KB per block at |T| = 16 (64 KB per lane), up to
  // 227 KB per block at |T| = 256.
  int sms = 0;
  PassLaunch cn, vn;
  cudaError_t err = hbm_tiles::sm_count(&sms);
  if (err == cudaSuccess)
    err = plan_pass(cn_kernel<true>, cn_kernel<false>, bt, n_checks, n_tiles, sms, p.d_c_max,
                    cn_tables_bytes(true, p.n_cn_slots, p.slot),
                    cn_tables_bytes(false, p.n_cn_slots, p.slot),
                    int(sizeof(int)) * bt + cn_match, 2, &cn);
  if (err == cudaSuccess)
    err = plan_pass(vn_kernel<true>, vn_kernel<false>, bt, p.n_vars, n_tiles, sms, p.d_v_max,
                    vn_tables_bytes(true, p.n_vn_slots, p.slot),
                    vn_tables_bytes(false, p.n_vn_slots, p.slot), vn_match, 1, &vn);
  const int decide_smem = p.n_vn_slots * p.slot;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               decide_smem);
  if (err != cudaSuccess) return int(err);
  const dim3 seed_grid = hbm_tiles::pass_grid(p.n_edges * bt, n_tiles, sms);
  const dim3 decide_grid = hbm_tiles::pass_grid(p.n_vars * bt, n_tiles, sms);
  const auto cn_pass_launch = [&](int k, int count) {
    if (cn.lanes)
      cn_kernel<true><<<cn.lanes_shape.grid, cn.lanes_shape.threads, cn.lanes_smem, s>>>(
          p, k, count, 0);
    if (cn.general)
      cn_kernel<false><<<cn.general_shape.grid, cn.general_shape.threads, cn.general_smem, s>>>(
          p, k, count, cn.min_degree);
  };
  const auto vn_pass_launch = [&](int i) {
    if (vn.lanes)
      vn_kernel<true><<<vn.lanes_shape.grid, vn.lanes_shape.threads, vn.lanes_smem, s>>>(p, i,
                                                                                          0);
    if (vn.general)
      vn_kernel<false><<<vn.general_shape.grid, vn.general_shape.threads, vn.general_smem, s>>>(
          p, i, vn.min_degree);
  };

  HBM_LAUNCH(seed_kernel<<<seed_grid, hbm_tiles::kThreads, 0, s>>>(p));
  HBM_LAUNCH(cn_pass_launch(0, 0));
  for (int i = 0; i < imax - 1; ++i) {
    HBM_LAUNCH(vn_pass_launch(i));
    HBM_LAUNCH(cn_pass_launch(i + 1, 1));
    HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, i));
  }
  HBM_LAUNCH(decide_kernel<<<decide_grid, hbm_tiles::kThreads, decide_smem, s>>>(p));
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt` (a multiple of kVec, at most
// hbm_wide's kMaxTile) on `stream`; A, B, chg, unsat and state are the
// caller's scratch (see Params). Returns the first cudaError_t of the
// attribute calls or the launches.
int ib_lut_hbm_decode(const int32_t* clusters, int32_t* outputs, int32_t* unsat_out,
                      int32_t* iters_out, const uint8_t* cn_tab, const uint8_t* vn_tab,
                      const uint8_t* match_cn, const uint8_t* match_vn,
                      const int32_t* seed_var, const int32_t* node_var,
                      const int32_t* cn_route, const int32_t* vn_route,
                      const int32_t* cn_groups, const int32_t* vn_groups, uint8_t* A,
                      uint8_t* B, uint8_t* chg, int32_t* unsat, int32_t* state,
                      int n_cn_groups, int n_vn_groups, int n_vars, int n_checks,
                      int n_edges, int batch, int bt, int t_channel, int t_decoder,
                      int n_cn_slots, int n_vn_slots, int slot, int d_c_max, int d_v_max,
                      int imax, int early_exit, void* stream) {
  if (!hbm_wide::takes_tile(bt, kVec)) return int(cudaErrorInvalidValue);
  const ib_lut::Graph g{cn_groups,   vn_groups,   cn_route, vn_route, node_var,
                        n_cn_groups, n_vn_groups, bt,       t_decoder};
  const Params p{clusters,  outputs,   unsat_out,  iters_out,  cn_tab, vn_tab,  match_cn,
                 match_vn,  seed_var,  g,          A,          B,      chg,     unsat,
                 state,     n_vars,    n_edges,    batch,      t_channel,
                 n_cn_slots, n_vn_slots, slot,     d_c_max,    d_v_max, early_exit};
  return decode(p, n_checks, imax, static_cast<cudaStream_t>(stream));
}

int ib_lut_hbm_max_degree() { return kMaxDegree; }
int ib_lut_hbm_vec() { return kVec; }
int ib_lut_hbm_max_tile() { return hbm_wide::kMaxTile; }

const char* ib_lut_hbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
