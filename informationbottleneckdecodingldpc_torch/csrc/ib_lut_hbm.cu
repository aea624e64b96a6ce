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
// Layout: the views are uint8 [tile][row][bt] in device memory, so a tile's
// slab is indexed as K1 indexes shared memory and the routed writes of one
// row are bt contiguous bytes; the channel clusters are converted once to a
// uint8 [tile][var][bt] plane. The folds are K1's (ib_lut_groups.cuh).
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
// (149 at i_max 50).
//
// What bounds it on this card (counts from shapes, not measurements): each
// body reads and writes both byte views once, 4 x 226,799 B = 907 KB per
// DVB-S2 codeword, 929 MB per body at batch 1024, and one 128-codeword tile's
// two views (58 MB) exceed the 50 MB L2, so device-memory bandwidth bounds
// it: about 0.28 ms per body at the data sheet's 3.35 TB/s. Byte loads and
// scattered byte stores fill 32-byte sectors only when bt is a multiple of
// 32. Keeping a tile resident across a cluster's distributed shared memory,
// TMA staging and wider per-thread work are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ib_lut_groups.cuh"
#include "hbm_tiles.cuh"

namespace {

using ib_lut::Luts;

using hbm_tiles::first_item;
using hbm_tiles::item_step;
using hbm_tiles::kThreads;
using hbm_tiles::tile_done;
using hbm_tiles::view_base;

constexpr int kMaxDegree = 16;

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

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                                      int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = __ldg(&src[t]);
}

__global__ void __launch_bounds__(kThreads) seed_kernel(Params p) {
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

// CN pass of DE iteration k (k = 0: the iteration-0 tables, rows of Tch),
// A -> B; with `count`, the syndrome of the inputs is added to the tile's
// unsat counts.
__global__ void __launch_bounds__(kThreads) cn_kernel(Params p, int k, int count) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;  // uniform over the block
  extern __shared__ __align__(16) uint8_t smem[];
  int* u = reinterpret_cast<int*>(smem);  // [bt] this block's counts
  uint8_t* TC = smem + sizeof(int) * bt;
  uint8_t* MC = TC + p.n_cn_slots * p.slot;
  const int cn_stage = p.n_cn_slots * p.slot, mc_stage = p.d_c_max * p.g.t_decoder;
  stage(TC, p.cn_tab + size_t(k) * cn_stage, cn_stage);
  stage(MC, p.match_cn + size_t(k) * mc_stage, mc_stage);
  if (count)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
  __syncthreads();
  const Luts lut{TC, p.slot, k == 0 ? p.t_channel : p.g.t_decoder};
  ib_lut::cn_pass(p.g, p.A + view_base(p, tile), p.B + view_base(p, tile), lut, MC,
                  count ? u : nullptr, first_item(), item_step());
  if (count) {
    __syncthreads();
    for (int c = threadIdx.x; c < bt; c += blockDim.x)
      if (u[c]) atomicAdd(&p.unsat[tile * bt + c], u[c]);
  }
}

// VN pass of body i, B -> A; zeroes the tile's unsat counts for this body.
__global__ void __launch_bounds__(kThreads) vn_kernel(Params p, int i) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* TV = smem;
  uint8_t* MV = TV + p.n_vn_slots * p.slot;
  const int vn_stage = p.n_vn_slots * p.slot, mv_stage = p.d_v_max * p.g.t_decoder;
  stage(TV, p.vn_tab + size_t(i) * vn_stage, vn_stage);
  stage(MV, p.match_vn + size_t(i) * mv_stage, mv_stage);
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) p.unsat[tile * bt + c] = 0;
  __syncthreads();
  ib_lut::vn_pass(p.g, p.B + view_base(p, tile), p.A + view_base(p, tile),
                  p.chg + size_t(tile) * p.n_vars * bt, Luts{TV, p.slot, p.g.t_decoder},
                  MV, first_item(), item_step());
}

// Decision with the VN tables of the tile's own iteration count.
__global__ void __launch_bounds__(kThreads) decide_kernel(Params p) {
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

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt` on `stream`; A, B, chg, unsat
// and state are the caller's scratch (see Params). Returns the first
// cudaError_t of the attribute calls or the launches.
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
  const ib_lut::Graph g{cn_groups,   vn_groups,   cn_route, vn_route, node_var,
                        n_cn_groups, n_vn_groups, bt,       t_decoder};
  const Params p{clusters,  outputs,   unsat_out,  iters_out,  cn_tab, vn_tab,  match_cn,
                 match_vn,  seed_var,  g,          A,          B,      chg,     unsat,
                 state,     n_vars,    n_edges,    batch,      t_channel,
                 n_cn_slots, n_vn_slots, slot,     d_c_max,    d_v_max, early_exit};
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (batch + bt - 1) / bt;
  // Tables of one pass: a few KB at |T| = 16, up to 227 KB at |T| = 256.
  const int cn_smem = sizeof(int) * bt + n_cn_slots * slot + d_c_max * t_decoder;
  const int vn_smem = n_vn_slots * slot + d_v_max * t_decoder;
  int sms = 0;
  cudaError_t err = hbm_tiles::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cn_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(vn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               vn_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               vn_smem);
  if (err != cudaSuccess) return int(err);

  const dim3 seed_grid = hbm_tiles::pass_grid(n_edges * bt, n_tiles, sms);
  const dim3 cn_grid = hbm_tiles::pass_grid(n_checks * bt, n_tiles, sms);
  const dim3 vn_grid = hbm_tiles::pass_grid(n_vars * bt, n_tiles, sms);

  HBM_LAUNCH(seed_kernel<<<seed_grid, kThreads, 0, s>>>(p));
  HBM_LAUNCH(cn_kernel<<<cn_grid, kThreads, cn_smem, s>>>(p, 0, 0));
  for (int i = 0; i < imax - 1; ++i) {
    HBM_LAUNCH(vn_kernel<<<vn_grid, kThreads, vn_smem, s>>>(p, i));
    HBM_LAUNCH(cn_kernel<<<cn_grid, kThreads, cn_smem, s>>>(p, i + 1, 1));
    HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, i));
  }
  HBM_LAUNCH(decide_kernel<<<vn_grid, kThreads, vn_smem, s>>>(p));
  return int(cudaSuccess);
}

int ib_lut_hbm_max_degree() { return kMaxDegree; }

const char* ib_lut_hbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
