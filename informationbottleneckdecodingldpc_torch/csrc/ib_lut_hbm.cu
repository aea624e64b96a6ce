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
// Layout: the views are [tile][row][bt] in device memory (bt = 128
// codewords by default; any multiple of 8 up to hbm_wide's kMaxTile), so a
// tile's slab is indexed as K1 indexes shared memory and the routed writes
// of one row are contiguous; the channel clusters are converted once to a
// [tile][var][bt] plane. When the tables give |T_ch| <= 16 and |T| <= 16,
// every message and channel cluster is 4 bits and the views and the plane
// hold two columns a byte (a row bt / 2 bytes; column 2k in the low nibble
// of byte k, 2k + 1 in its high nibble: hbm_wide.cuh's Nibbles); otherwise
// one a byte (Bytes). The width is a template argument of every kernel but
// the exit pass, so a trace names the path that ran. |T| = 32 stays on
// bytes: 5-bit messages put 8 columns in 40 bits, which no aligned access
// moves, and its tables miss the per-lane copies anyway. The folds are
// K1's (ib_lut_groups.cuh cn_fold / vn_fold), on one message per column.
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
// body reads and writes both views once and reads the channel plane,
// 4 x 226,799 + 64,800 messages per DVB-S2 codeword. At 4 bits (|T| = 16)
// that is 497 MB per body at batch 1024, 0.148 ms at the data sheet's
// 3.35 TB/s, and one 128-codeword tile's two views (29 MB, 33 MB with its
// channel plane) fit the 50 MB L2; at a byte it was 995 MB, 0.297 ms, and
// 58 MB a tile. The table lookups now bound it: about 1.9 M per codeword
// and body, 0.233 ms per body at one shared-memory load per lane and clock,
// twice that when two lanes of a warp meet in a bank, as random bytes of a
// 256-byte table (|T| = 16: 64 words over 32 banks) mostly do. So:
// - the CN and VN passes are wide (hbm_wide.cuh): a thread takes kVec = 8
//   columns of a node (80 registers on bytes, 64 and 48 packed; 16 took 128
//   and ran 7% slower, 4 ran 6% slower on the H100), loads each input row
//   with one 4-byte (packed) or 8-byte vector load, takes the columns apart
//   in registers for the folds, and stores each routed output row with one
//   access of the same width (at bt = 128 a packed row is 64 B, two whole
//   32-byte sectors of 8 lanes each); a route is read once per 8 columns;
// - a lookup is one multiply-add and one shared-memory load (LaneLuts), and
//   a check node's syndrome is one XOR of its input rows where T is a power
//   of two: once the views moved half the bytes, the passes' instruction
//   issue held them;
// - the folds' lookups stay direct byte-table loads from shared memory on
//   CUDA cores, from a copy of the pairwise tables per lane (LaneLuts, K5b's
//   conflict-free layout) for nodes up to the split degree, 64 KB per block
//   at |T| = 16. Nodes above the split degree, or every node when the copies
//   do not fit (|T| = 32), run in a general kernel at 4 columns per access
//   with one copy of the tables per block (Luts);
// - the seed and the decision touch natural-order [n_vars, batch] rows whose
//   alignment follows the batch; they run once per decode, the seed a view
//   byte per thread, the decision a column per thread.

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
using hbm_wide::element;
using hbm_wide::kSplitDegree;
using hbm_wide::Row;
using hbm_wide::row_bytes;
using hbm_wide::RowItems;

constexpr int kMaxDegree = 16;
constexpr int kVec = 8;         // columns per access of the per-lane kernels
constexpr int kGeneralVec = 4;  // columns per access of the general kernels
// The largest |T| (and |T_ch|) whose messages the views hold at 4 bits.
constexpr int kPackedT = 16;
// The per-lane copies are used up to this size, so that two blocks fit an SM.
constexpr int kMaxLaneTableBytes = 96 * 1024;
// LUT slots of nodes up to the split degree: a CN fold of degree d takes
// LUTs 0 .. d-3, a VN fold LUTs 0 .. d-1.
constexpr int kLaneCnSlots = kSplitDegree - 2;
constexpr int kLaneVnSlots = kSplitDegree;

// Columns per access of a pass kernel: the per-lane one (LANES) or the general.
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
  // At 4 bits a message the rows below hold bt / 2 bytes (hbm_wide.cuh).
  uint8_t* A;               // [n_tiles, n_edges, bt] CN view
  uint8_t* B;               // [n_tiles, n_edges, bt] VN view
  uint8_t* chg;             // [n_tiles, n_vars, bt] channel clusters, group order
  int32_t* unsat;           // [n_tiles, bt] syndrome counts of the tile's last body
  int32_t* state;           // [n_tiles, 2] done flag, bodies run
  int n_vars, n_edges, batch;
  int t_channel, n_cn_slots, n_vn_slots, slot, d_c_max, d_v_max;
  int early_exit;
};

// Slot stride of the per-lane copies at BITS bits a message: at 4 bits a
// constant, kPackedT^2 (the largest slot the packed path has), so that a
// lookup's slot offset is a load's immediate; at a byte (0) the tables' own.
template <int BITS>
constexpr int kLaneSlot = BITS == 4 ? kPackedT * kPackedT : 0;
template <int BITS>
__host__ __device__ __forceinline__ int lane_slot(int slot) {
  return kLaneSlot<BITS> ? kLaneSlot<BITS> : slot;
}

// Pairwise LUTs of one pass with a copy per lane, the layout of K5b's
// lookup2d_lanes (peaks.cu): lane l's copy of entry x of slot s is byte s % 4
// of word ((s / 4) * slot + x) * 32 + l, so each lane reads only its own bank.
// Entry a * stride + b of slot s sits 128 (a * stride + b) bytes from the
// slot's start, so a lookup is one multiply-add, a * 128 stride on the
// lane's row of b (ib_lut::lane_row), and one load whose offset is a
// constant when SLOT (the slot stride) is.
template <int SLOT>
struct LaneLuts {
  const uint8_t* base;  // the block's copies
  uint32_t lane;        // 4 * lane
  int slot;             // the slot stride when SLOT is 0
  int stride128;        // 128 x the tables' row stride
  __device__ __forceinline__ uint8_t operator()(int l, int a, int b) const {
    const int group = (l >> 2) * (SLOT ? SLOT : slot);
    return base[a * stride128 + ib_lut::lane_row(lane, b) + (group << 7) + (l & 3)];
  }
};

// Bytes of the per-lane copies of `slots` LUTs at a slot stride of `slot`.
__host__ __device__ __forceinline__ int lane_table_bytes(int slots, int slot) {
  return (slots + 3) / 4 * slot * 128;
}

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                                      int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = __ldg(&src[t]);
}

// The per-lane copies of `slots` LUTs of `slot` bytes at `src`, at a slot
// stride of `dst_slot` >= slot: a thread packs the four slots' bytes of one
// entry into a word and stores it for four lanes with one 16-byte store, a
// warp 32 lanes' words of one entry.
__device__ __forceinline__ void stage_lanes(uint8_t* dst, const uint8_t* __restrict__ src,
                                            int slots, int slot, int dst_slot) {
  const int words = (slots + 3) / 4 * dst_slot;
  for (int i = threadIdx.x; i < 8 * words; i += blockDim.x) {
    const int w = i >> 3, grp = w / dst_slot, x = w - grp * dst_slot;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * grp + b < slots && x < slot)
        v |= uint32_t(__ldg(&src[(4 * grp + b) * slot + x])) << (8 * b);
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(v, v, v, v);
  }
}

// Byte offsets of a tile's view slab and channel plane at BITS bits a message.
template <int BITS>
__device__ __forceinline__ size_t view_slab(const Params& p, int tile) {
  return view_base(p, tile) * BITS / 8;
}
template <int BITS>
__device__ __forceinline__ size_t plane_slab(const Params& p, int tile) {
  return size_t(tile) * p.n_vars * p.g.bt * BITS / 8;
}

// Columns c .. c + 8 / BITS - 1 of a [batch] clusters row as one view byte of
// BITS-bit messages; columns at or past the batch hold 0.
template <int BITS>
__device__ __forceinline__ uint8_t pack_clusters(const int32_t* row, int c, int batch) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 8 / BITS; ++j)
    if (c + j < batch) v |= (uint32_t(row[c + j]) & ((1u << BITS) - 1)) << (BITS * j);
  return uint8_t(v);
}

template <int BITS>
__global__ void __launch_bounds__(hbm_tiles::kThreads) seed_kernel(Params p) {
  constexpr int kPerByte = 8 / BITS;
  const int tile = blockIdx.y, rb = row_bytes<BITS>(p.g.bt), b0 = tile * p.g.bt;
  uint8_t* A = p.A + view_slab<BITS>(p, tile);
  uint8_t* chg = p.chg + plane_slab<BITS>(p, tile);
  for (int t = first_item(); t < p.n_edges * rb; t += item_step()) {
    const int r = t / rb, col = b0 + (t - r * rb) * kPerByte;
    A[t] = pack_clusters<BITS>(p.clusters + size_t(__ldg(&p.seed_var[r])) * p.batch, col,
                               p.batch);
  }
  for (int t = first_item(); t < p.n_vars * rb; t += item_step()) {
    const int r = t / rb, col = b0 + (t - r * rb) * kPerByte;
    chg[t] = pack_clusters<BITS>(p.clusters + size_t(__ldg(&p.g.node_var[r])) * p.batch, col,
                                 p.batch);
  }
  if (blockIdx.x == 0 && threadIdx.x < 2) p.state[2 * tile + threadIdx.x] = 0;
}

// One check group of degree D, V columns of BITS-bit messages per item: D
// vector loads, the syndrome of the inputs (with `unsat`), V column folds in
// registers, D routed vector stores.
template <int V, int BITS, int D, class Lut>
__device__ void cn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, Lut lut,
                         const uint8_t* __restrict__ match_row,
                         const int32_t* __restrict__ route, int off, int n, int thresh,
                         int* unsat, int bt, RowItems it) {
  const int rb = row_bytes<BITS>(bt), cb = row_bytes<BITS>(it.c0);
  for (int node = it.node; node < n; node += it.node_step) {
    Row<V, BITS> in[D];
    int row[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      in[k].load(src + (off + k * n + node) * rb + cb);
      row[k] = __ldg(&route[off + k * n + node]);
    }
    if (unsat != nullptr) {
      if (thresh > 0 && (thresh & (thresh - 1)) == 0) {
        // thresh = T / 2 a power of two and every t < T: t < thresh exactly
        // when bit thresh of t is clear, so one XOR of the rows gives every
        // column's parity of the inputs' hard bits.
        Row<V, BITS> x = in[0];
#pragma unroll
        for (int k = 1; k < D; ++k) x.xor_with(in[k]);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (((x.get(j) & thresh) != 0) != (D % 2 == 1)) atomicAdd(&unsat[it.c0 + j], 1);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          int parity = 0;
#pragma unroll
          for (int k = 0; k < D; ++k) parity ^= int(in[k].get(j) < thresh);
          if (parity) atomicAdd(&unsat[it.c0 + j], 1);
        }
      }
    }
    Row<V, BITS> out[D];
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
    for (int k = 0; k < D; ++k) out[k].store(dst + row[k] * rb + cb);
  }
}

// One variable group of degree D, V columns of BITS-bit messages per item,
// with the channel rows.
template <int V, int BITS, int D, class Lut>
__device__ void vn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                         const uint8_t* __restrict__ chg, Lut lut,
                         const uint8_t* __restrict__ match_row,
                         const int32_t* __restrict__ route, int off, int n, int node_off,
                         int bt, RowItems it) {
  const int rb = row_bytes<BITS>(bt), cb = row_bytes<BITS>(it.c0);
  for (int node = it.node; node < n; node += it.node_step) {
    Row<V, BITS> ch;
    ch.load(chg + (node_off + node) * rb + cb);
    if constexpr (D == 1) {
      // Degree-1 variable nodes forward the channel, unaligned.
      ch.store(dst + __ldg(&route[off + node]) * rb + cb);
    } else {
      Row<V, BITS> in[D], out[D];
      int row[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        in[k].load(src + (off + k * n + node) * rb + cb);
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
      for (int k = 0; k < D; ++k) out[k].store(dst + row[k] * rb + cb);
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
template <bool LANES, int BITS, class Lut>
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
    cn_group<V, BITS, D>(src, dst, lut, row, g.cn_route, off, n, g.t_decoder / 2, unsat,    \
                         g.bt, it);                                                         \
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
template <bool LANES, int BITS, class Lut>
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
    vn_group<V, BITS, D>(src, dst, chg, lut, row, g.vn_route, off, n, node_off, g.bt, it);\
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

// Shared memory of a pass's tables: per lane at a slot stride of
// `lanes_slot`, or per block.
__host__ __device__ __forceinline__ int cn_tables_bytes(bool lanes, int n_cn_slots, int slot,
                                                        int lanes_slot) {
  return lanes ? lane_table_bytes(n_cn_slots < kLaneCnSlots ? n_cn_slots : kLaneCnSlots,
                                  lanes_slot)
               : n_cn_slots * slot;
}
__host__ __device__ __forceinline__ int vn_tables_bytes(bool lanes, int n_vn_slots, int slot,
                                                        int lanes_slot) {
  return lanes ? lane_table_bytes(n_vn_slots < kLaneVnSlots ? n_vn_slots : kLaneVnSlots,
                                  lanes_slot)
               : n_vn_slots * slot;
}

// CN pass of DE iteration k (k = 0: the iteration-0 tables, rows of Tch),
// A -> B at BITS bits a message; with `count`, the syndrome of the inputs is
// added to the tile's unsat counts.
template <bool LANES, int BITS>
__global__ void __launch_bounds__(hbm_wide::kThreads)
    cn_kernel(Params p, int k, int count, int min_degree) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;  // uniform over the block
  extern __shared__ __align__(16) uint8_t smem[];
  int* u = reinterpret_cast<int*>(smem);  // [bt] this block's counts
  uint8_t* TC = smem + sizeof(int) * bt;  // 16-byte aligned: bt is a multiple of 8
  uint8_t* MC = TC + cn_tables_bytes(LANES, p.n_cn_slots, p.slot, lane_slot<BITS>(p.slot));
  const uint8_t* tab = p.cn_tab + size_t(k) * p.n_cn_slots * p.slot;
  const int mc_stage = p.d_c_max * p.g.t_decoder;
  if constexpr (LANES)
    stage_lanes(TC, tab, p.n_cn_slots < kLaneCnSlots ? p.n_cn_slots : kLaneCnSlots, p.slot,
                lane_slot<BITS>(p.slot));
  else
    stage(TC, tab, p.n_cn_slots * p.slot);
  stage(MC, p.match_cn + size_t(k) * mc_stage, mc_stage);
  if (count)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
  __syncthreads();
  const int stride = k == 0 ? p.t_channel : p.g.t_decoder;
  const uint8_t* src = p.A + view_slab<BITS>(p, tile);
  uint8_t* dst = p.B + view_slab<BITS>(p, tile);
  int* unsat = count ? u : nullptr;
  if constexpr (LANES)
    cn_pass<true, BITS>(p.g, src, dst,
                        LaneLuts<kLaneSlot<BITS>>{TC, 4 * (threadIdx.x & 31), p.slot,
                                                  stride << 7},
                        MC, unsat, min_degree);
  else
    cn_pass<false, BITS>(p.g, src, dst, Luts{TC, p.slot, stride}, MC, unsat, min_degree);
  if (count) {
    __syncthreads();
    for (int c = threadIdx.x; c < bt; c += blockDim.x)
      if (u[c]) atomicAdd(&p.unsat[tile * bt + c], u[c]);
  }
}

// VN pass of body i, B -> A at BITS bits a message; zeroes the tile's unsat
// counts for this body.
template <bool LANES, int BITS>
__global__ void __launch_bounds__(hbm_wide::kThreads) vn_kernel(Params p, int i, int min_degree) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* TV = smem;
  uint8_t* MV = TV + vn_tables_bytes(LANES, p.n_vn_slots, p.slot, lane_slot<BITS>(p.slot));
  const uint8_t* tab = p.vn_tab + size_t(i) * p.n_vn_slots * p.slot;
  const int mv_stage = p.d_v_max * p.g.t_decoder;
  if constexpr (LANES)
    stage_lanes(TV, tab, p.n_vn_slots < kLaneVnSlots ? p.n_vn_slots : kLaneVnSlots, p.slot,
                lane_slot<BITS>(p.slot));
  else
    stage(TV, tab, p.n_vn_slots * p.slot);
  stage(MV, p.match_vn + size_t(i) * mv_stage, mv_stage);
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) p.unsat[tile * bt + c] = 0;
  __syncthreads();
  const uint8_t* src = p.B + view_slab<BITS>(p, tile);
  uint8_t* dst = p.A + view_slab<BITS>(p, tile);
  const uint8_t* chg = p.chg + plane_slab<BITS>(p, tile);
  if constexpr (LANES)
    vn_pass<true, BITS>(p.g, src, dst, chg,
                        LaneLuts<kLaneSlot<BITS>>{TV, 4 * (threadIdx.x & 31), p.slot,
                                                  p.g.t_decoder << 7},
                        MV, min_degree);
  else
    vn_pass<false, BITS>(p.g, src, dst, chg, Luts{TV, p.slot, p.g.t_decoder}, MV, min_degree);
}

// Decision fold of one variable group of degree D from the VN view `src`
// and the channel plane `chg` of one tile (BITS bits a message), written to
// outputs[var][batch] at columns b0 + c < batch.
template <int D, int BITS>
__device__ void decide_group(const uint8_t* __restrict__ src, const uint8_t* __restrict__ chg,
                             Luts lut, const int32_t* __restrict__ node_var,
                             int32_t* __restrict__ outputs, int off, int n, int node_off, int bt,
                             int b0, int batch, int first, int step) {
  const int items = n * bt;
  for (int t = first; t < items; t += step) {
    const int node = t / bt;
    const int c = t - node * bt;
    if (b0 + c >= batch) continue;
    uint8_t s = lut(0, element<BITS>(chg, (node_off + node) * bt + c),
                    element<BITS>(src, (off + node) * bt + c));
#pragma unroll
    for (int k = 1; k < D; ++k) s = lut(k, s, element<BITS>(src, (off + k * n + node) * bt + c));
    outputs[size_t(__ldg(&node_var[node_off + node])) * batch + b0 + c] = s;
  }
}

// Decision with the VN tables of the tile's own iteration count.
template <int BITS>
__global__ void __launch_bounds__(hbm_tiles::kThreads) decide_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  const int iters = p.state[2 * tile + 1];
  extern __shared__ __align__(16) uint8_t smem[];
  const int vn_stage = p.n_vn_slots * p.slot;
  stage(smem, p.vn_tab + size_t(iters) * vn_stage, vn_stage);
  __syncthreads();
  const uint8_t* src = p.B + view_slab<BITS>(p, tile);
  const uint8_t* chg = p.chg + plane_slab<BITS>(p, tile);
  const Luts lut{smem, p.slot, p.g.t_decoder};
  for (int k = 0; k < p.g.n_vn_groups; ++k) {
    const int off = p.g.vn_groups[4 * k], n = p.g.vn_groups[4 * k + 1];
    const int d = p.g.vn_groups[4 * k + 2], node_off = p.g.vn_groups[4 * k + 3];
    switch (d) {
#define K3_DEC_CASE(D)                                                                      \
  case D:                                                                                   \
    decide_group<D, BITS>(src, chg, lut, p.g.node_var, p.outputs, off, n, node_off, bt, b0, \
                          p.batch, first_item(), item_step());                              \
    break;
      K3_DEC_CASE(1)
      IB_DEGREES_2_TO_16(K3_DEC_CASE)
#undef K3_DEC_CASE
      default:
        __trap();
    }
  }
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

template <int BITS>
int decode(const Params& p, int n_checks, int imax, cudaStream_t s) {
  const int bt = p.g.bt, n_tiles = (p.batch + bt - 1) / bt;
  const int cn_match = p.d_c_max * p.g.t_decoder, vn_match = p.d_v_max * p.g.t_decoder;
  // Tables of one pass: a few KB per block at |T| = 16 (64 KB per lane), up to
  // 227 KB per block at |T| = 256.
  int sms = 0;
  PassLaunch cn, vn;
  cudaError_t err = hbm_tiles::sm_count(&sms);
  if (err == cudaSuccess)
    err = plan_pass(cn_kernel<true, BITS>, cn_kernel<false, BITS>, bt, n_checks, n_tiles, sms, p.d_c_max,
                    cn_tables_bytes(true, p.n_cn_slots, p.slot, lane_slot<BITS>(p.slot)),
                    cn_tables_bytes(false, p.n_cn_slots, p.slot, p.slot),
                    int(sizeof(int)) * bt + cn_match, 2, &cn);
  if (err == cudaSuccess)
    err = plan_pass(vn_kernel<true, BITS>, vn_kernel<false, BITS>, bt, p.n_vars, n_tiles, sms, p.d_v_max,
                    vn_tables_bytes(true, p.n_vn_slots, p.slot, lane_slot<BITS>(p.slot)),
                    vn_tables_bytes(false, p.n_vn_slots, p.slot, p.slot), vn_match, 1, &vn);
  const int decide_smem = p.n_vn_slots * p.slot;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decide_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               decide_smem);
  if (err != cudaSuccess) return int(err);
  const dim3 seed_grid = hbm_tiles::pass_grid(p.n_edges * row_bytes<BITS>(bt), n_tiles, sms);
  const dim3 decide_grid = hbm_tiles::pass_grid(p.n_vars * bt, n_tiles, sms);
  const auto cn_pass_launch = [&](int k, int count) {
    if (cn.lanes)
      cn_kernel<true, BITS><<<cn.lanes_shape.grid, cn.lanes_shape.threads, cn.lanes_smem, s>>>(
          p, k, count, 0);
    if (cn.general)
      cn_kernel<false, BITS>
          <<<cn.general_shape.grid, cn.general_shape.threads, cn.general_smem, s>>>(
              p, k, count, cn.min_degree);
  };
  const auto vn_pass_launch = [&](int i) {
    if (vn.lanes)
      vn_kernel<true, BITS><<<vn.lanes_shape.grid, vn.lanes_shape.threads, vn.lanes_smem, s>>>(
          p, i, 0);
    if (vn.general)
      vn_kernel<false, BITS>
          <<<vn.general_shape.grid, vn.general_shape.threads, vn.general_smem, s>>>(
              p, i, vn.min_degree);
  };

  HBM_LAUNCH(seed_kernel<BITS><<<seed_grid, hbm_tiles::kThreads, 0, s>>>(p));
  HBM_LAUNCH(cn_pass_launch(0, 0));
  for (int i = 0; i < imax - 1; ++i) {
    HBM_LAUNCH(vn_pass_launch(i));
    HBM_LAUNCH(cn_pass_launch(i + 1, 1));
    HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, i));
  }
  HBM_LAUNCH(decide_kernel<BITS><<<decide_grid, hbm_tiles::kThreads, decide_smem, s>>>(p));
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt` (a multiple of kVec, at most
// hbm_wide's kMaxTile) on `stream` with views of `view_bits` bits a message
// (4, which takes |T_ch| and |T| up to kPackedT, or 8); A, B, chg, unsat and
// state are the caller's scratch (see Params). Returns the first cudaError_t
// of the attribute calls or the launches.
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
                      int imax, int early_exit, int view_bits, void* stream) {
  if (!hbm_wide::takes_tile(bt, kVec)) return int(cudaErrorInvalidValue);
  const bool packed = view_bits == 4;
  if (packed ? t_channel > kPackedT || t_decoder > kPackedT : view_bits != 8)
    return int(cudaErrorInvalidValue);
  const ib_lut::Graph g{cn_groups,   vn_groups,   cn_route, vn_route, node_var,
                        n_cn_groups, n_vn_groups, bt,       t_decoder};
  const Params p{clusters,  outputs,   unsat_out,  iters_out,  cn_tab, vn_tab,  match_cn,
                 match_vn,  seed_var,  g,          A,          B,      chg,     unsat,
                 state,     n_vars,    n_edges,    batch,      t_channel,
                 n_cn_slots, n_vn_slots, slot,     d_c_max,    d_v_max, early_exit};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return packed ? decode<4>(p, n_checks, imax, s) : decode<8>(p, n_checks, imax, s);
}

int ib_lut_hbm_max_degree() { return kMaxDegree; }
int ib_lut_hbm_vec() { return kVec; }
int ib_lut_hbm_max_tile() { return hbm_wide::kMaxTile; }
int ib_lut_hbm_packed_t() { return kPackedT; }

const char* ib_lut_hbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
