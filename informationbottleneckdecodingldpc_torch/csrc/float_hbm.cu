// K4: float (min-sum / BP) LDPC decoder with both message views in device
// memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/float_hbm.py:_build_float_hbm_kernel, for codes whose float32
// views do not fit one CTA's shared memory (DVB-S2 N=64800: 2.07 MB per
// codeword). It has K3's chassis (ib_lut_hbm.cu) with float32 views
// [tile][row][bt] and K2's node rules (float_groups.cuh): min-sum min1/min2
// with the zero count and negative parity, BP box-plus by prefix/suffix, VN
// clamp +-150, decision unclamped, every add, subtract and multiply an
// explicitly rounded intrinsic.
//
// Exit convention: K2's and the plain decoder's, not the JAX kernel's. The
// JAX kernel tests the syndrome on the staged CN view of the next body, so a
// tile leaves one body late and reports one more iteration. Here a separate
// syndrome pass over the new CN view follows each body's VN pass, and the tile
// leaves right after the body whose VN->CN messages satisfy every check:
// outputs, unsat and iterations equal float_decode_tiled's.
//
// Per decode, every pass one launch over all tiles (grid y = tile), all
// enqueued on one stream with no host sync:
//   seed: CN view A <- channel LLR of each row's variable, channel plane, the
//     tile's state zeroed (padding columns hold 0 and take part in the exit
//     test);
//   per body i = 0 .. imax-2: CN pass A -> B; VN pass B -> A (the tile's
//     unsat counts zeroed); then, with early exit or in the last body, the
//     syndrome of A counted per codeword in shared memory and added to the
//     tile's counts once per block, and the exit step (bodies run = i+1; with
//     early exit the tile is done when none of its codewords has an
//     unsatisfied check);
//   imax <= 1 runs no body: the syndrome of the seeded A, and B is zero (the
//   caller's scratch);
//   decision ch + left-fold sum of B at the natural variable index; unsat and
//   iters per codeword.
// Blocks of a finished tile return at once. Launches per decode: 1 + 4 (imax
// - 1) + 1 with early exit (198 at i_max 50), imax + 3 without.
//
// What bounds it on this card (counts from shapes, not measurements): a body
// reads and writes both views and reads A again for the syndrome, 5 x
// 226,799 x 4 B = 4.5 MB per DVB-S2 codeword (3.6 MB without the syndrome
// pass), 4.6 GB per body at batch 1024: device-memory bandwidth bounds
// min-sum, at about 1.4 ms per body at the data sheet's 3.35 TB/s; BP adds
// two expf and two log1pf per box-plus, 3(d-2) box-plus per check. The
// separate syndrome pass costs a quarter more traffic; folding it into the
// CN pass with a ping-ponged B view, and half-precision views, are later
// work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "float_groups.cuh"
#include "hbm_tiles.cuh"

namespace {

using float_llr::kBP;
using float_llr::kMinSum;

using hbm_tiles::first_item;
using hbm_tiles::item_step;
using hbm_tiles::kThreads;
using hbm_tiles::tile_done;
using hbm_tiles::view_base;

constexpr int kMaxDegree = 16;

struct Params {
  const float* llrs;         // [n_vars, batch]
  float* outputs;            // [n_vars, batch]
  int32_t* unsat_out;        // [batch]
  int32_t* iters_out;        // [batch]
  const int32_t* seed_var;   // [n_edges] variable of each CN-view row
  float_llr::Graph g;        // groups, routes, node order, bt
  float* A;                  // [n_tiles, n_edges, bt] CN view
  float* B;                  // [n_tiles, n_edges, bt] VN view
  float* chg;                // [n_tiles, n_vars, bt] channel LLRs, group order
  int32_t* unsat;            // [n_tiles, bt] syndrome counts of the tile's last body
  int32_t* state;            // [n_tiles, 2] done flag, bodies run
  int n_vars, n_edges, batch;
  int early_exit;
};

__global__ void __launch_bounds__(kThreads) seed_kernel(Params p) {
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

template <int RULE>
__global__ void __launch_bounds__(kThreads) cn_kernel(Params p) {
  const int tile = blockIdx.y;
  if (tile_done(p, tile)) return;
  float_llr::cn_pass<RULE>(p.g, p.A + view_base(p, tile), p.B + view_base(p, tile),
                           first_item(), item_step());
}

// VN pass B -> A; zeroes the tile's unsat counts for this body.
__global__ void __launch_bounds__(kThreads) vn_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt;
  if (tile_done(p, tile)) return;
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) p.unsat[tile * bt + c] = 0;
  float_llr::vn_pass(p.g, p.B + view_base(p, tile), p.A + view_base(p, tile),
                     p.chg + size_t(tile) * p.n_vars * bt, first_item(), item_step());
}

// Syndrome of A, counted per codeword in shared memory, then added to the
// tile's counts.
__global__ void __launch_bounds__(kThreads) syndrome_kernel(Params p) {
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

__global__ void __launch_bounds__(kThreads) decide_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt, b0 = tile * bt;
  float_llr::decide_pass(p.g, p.B + view_base(p, tile), p.chg + size_t(tile) * p.n_vars * bt,
                         p.outputs, b0, p.batch, first_item(), item_step());
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < bt; c += blockDim.x) {
      if (b0 + c >= p.batch) continue;
      p.unsat_out[b0 + c] = p.unsat[tile * bt + c];
      p.iters_out[b0 + c] = p.state[2 * tile + 1];
    }
}

template <int RULE>
int decode(const Params& p, int n_checks, int imax, cudaStream_t s) {
  const int bt = p.g.bt, n_tiles = (p.batch + bt - 1) / bt;
  int sms = 0;
  cudaError_t err = hbm_tiles::sm_count(&sms);
  if (err != cudaSuccess) return int(err);
  const dim3 seed_grid = hbm_tiles::pass_grid(p.n_edges * bt, n_tiles, sms);
  const dim3 cn_grid = hbm_tiles::pass_grid(n_checks * bt, n_tiles, sms);
  const dim3 vn_grid = hbm_tiles::pass_grid(p.n_vars * bt, n_tiles, sms);
  const size_t syn_smem = sizeof(int) * bt;

  HBM_LAUNCH(seed_kernel<<<seed_grid, kThreads, 0, s>>>(p));
  if (imax <= 1) HBM_LAUNCH(syndrome_kernel<<<cn_grid, kThreads, syn_smem, s>>>(p));
  for (int i = 0; i < imax - 1; ++i) {
    HBM_LAUNCH(cn_kernel<RULE><<<cn_grid, kThreads, 0, s>>>(p));
    HBM_LAUNCH(vn_kernel<<<vn_grid, kThreads, 0, s>>>(p));
    // Without early exit only the last body's syndrome is reported.
    if (p.early_exit || i == imax - 2) {
      HBM_LAUNCH(syndrome_kernel<<<cn_grid, kThreads, syn_smem, s>>>(p));
      HBM_LAUNCH(hbm_tiles::exit_kernel<<<n_tiles, 128, 0, s>>>(p, i));
    }
  }
  HBM_LAUNCH(decide_kernel<<<vn_grid, kThreads, 0, s>>>(p));
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt` on `stream` with the min-sum
// (rule 0) or BP (rule 1) check update; A, B, chg, unsat and state are the
// caller's scratch (see Params; B zeroed when imax <= 1). Returns the first
// cudaError_t of the launches.
int float_hbm_decode(int rule, const float* llrs, float* outputs, int32_t* unsat_out,
                     int32_t* iters_out, const int32_t* seed_var, const int32_t* node_var,
                     const int32_t* cn_route, const int32_t* vn_route,
                     const int32_t* cn_groups, const int32_t* vn_groups, float* A, float* B,
                     float* chg, int32_t* unsat, int32_t* state, int n_cn_groups,
                     int n_vn_groups, int n_vars, int n_checks, int n_edges, int batch,
                     int bt, int imax, int early_exit, void* stream) {
  const float_llr::Graph g{cn_groups,   vn_groups,   cn_route, vn_route,
                           node_var,    n_cn_groups, n_vn_groups, bt};
  const Params p{llrs, outputs, unsat_out, iters_out, seed_var, g,     A,      B,
                 chg,  unsat,   state,     n_vars,    n_edges,  batch, early_exit};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rule == kMinSum) return decode<kMinSum>(p, n_checks, imax, s);
  if (rule == kBP) return decode<kBP>(p, n_checks, imax, s);
  return int(cudaErrorInvalidValue);
}

int float_hbm_max_degree() { return kMaxDegree; }

const char* float_hbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
