// K1: fused IB lookup-table LDPC decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/ib_lut_fused.py:_build_kernel. It computes what that kernel
// computes, not how: one CTA decodes one tile of `bt` codewords from channel
// clusters to decisions with both message views resident in shared memory,
// so no message touches device memory during the decode.
//
// Per tile:
//   seed the CN view from the channel clusters and cache each variable
//   node's channel cluster (group order);
//   iteration-0 CN leave-one-out with the iteration-0 tables and
//   matching_cn[0], routed on write into the VN view;
//   loop i = 0 .. imax-2: VN leave-one-out with vn_first[i]/vn_rest[i] and
//   matching_vn[i] -> CN view; CN leave-one-out with cn_rest[i] and
//   matching_cn[i+1] -> VN view, with the syndrome of the VN->CN messages
//   (the CN inputs) summed per codeword on the way; the tile leaves the loop
//   when no codeword has an unsatisfied check (early exit) or after imax-1
//   bodies;
//   decision fold with the VN tables of iteration `iters`, written straight
//   to the natural variable index; unsat and iters per codeword.
//
// Semantics match the JAX decoder bit for bit (ops/lut_fold.py contract):
// every node output is a strict left-to-right fold of its input sequence
// with the own edge removed, step p through pairwise LUT p-1 indexed
// lut[state][next]. Padding columns of the last tile hold cluster 0 and take
// part in that tile's exit test, as in the JAX kernel. The node folds live in
// ib_lut_groups.cuh, which K3 (ib_lut_hbm.cu) shares.
//
// What bounds it on this card: the work is dependent byte lookups into small
// tables plus routed byte scatters, all in shared memory, and three block-wide
// barriers per iteration; device-memory traffic is only the channel clusters
// in and the decisions out (about 8 bytes per variable per codeword for a
// whole 50-iteration decode). So the limit is shared-memory lookup latency
// and bank conflicts, and barrier stalls, not HBM bandwidth. The design
// answers with messages as uint8 (WLAN: 2 x 4644 + 1296 bytes per codeword,
// so 16 codewords fit one CTA), tables staged per half-iteration into shared
// memory, one thread per (node, codeword) item with the node's inputs held
// in registers (degree is a template parameter), and the syndrome folded
// into the CN pass so it costs no extra pass or barrier. Making the lookups
// faster (prefix sharing is already done; suffix reuse, wider per-thread
// work, fewer barriers) is later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ib_lut_groups.cuh"

namespace {

using ib_lut::Luts;

// 1024 threads hold more dependent lookups in flight than 512 (15% faster on
// the WLAN headline on an H100 SXM); __launch_bounds__ then caps registers at 64, which the
// kernel fits without spills.
constexpr int kThreads = 1024;
constexpr int kMaxDegree = 16;

struct Params {
  const int32_t* clusters;   // [n_vars, batch]
  int32_t* outputs;          // [n_vars, batch]
  int32_t* unsat_out;        // [batch]
  int32_t* iters_out;        // [batch]
  const uint8_t* cn_tab;     // [i_max, n_cn_slots, slot]: CN LUTs per DE iteration
  const uint8_t* vn_tab;     // [i_max, n_vn_slots, slot]: vn_first, vn_rest...
  const uint8_t* match_cn;   // [i_max, d_c_max, T]
  const uint8_t* match_vn;   // [i_max, d_v_max, T]
  const int32_t* seed_var;   // [n_edges] variable of each CN-view row
  const int32_t* node_var;   // [n_vars] variable of each group-ordered VN
  const int32_t* cn_route;   // [n_edges] CN-view row -> VN-view row
  const int32_t* vn_route;   // [n_edges] VN-view row -> CN-view row
  const int32_t* cn_groups;  // [n_cn_groups, 3] (offset, num_nodes, degree)
  const int32_t* vn_groups;  // [n_vn_groups, 4] (offset, num_nodes, degree, node offset)
  int n_cn_groups, n_vn_groups;
  int n_vars, n_edges, batch, bt;
  int t_channel, t_decoder;
  int n_cn_slots, n_vn_slots, slot;
  int d_c_max, d_v_max;
  int imax, early_exit;
};

// Shared-memory carve; ib_lut_fused.py:shared_bytes mirrors it.
__host__ __device__ inline size_t shared_bytes(const Params& p) {
  return 2 * sizeof(int) * p.bt                    // unsat counts, 2 buffers
         + size_t(2 * p.n_edges + p.n_vars) * p.bt  // views A, B and channel
         + size_t(p.n_cn_slots + p.n_vn_slots) * p.slot
         + size_t(p.d_c_max + p.d_v_max) * p.t_decoder;
}

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                                      int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = __ldg(&src[t]);
}

__global__ void __launch_bounds__(kThreads) ib_lut_fused_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bt = p.bt;
  const int b0 = blockIdx.x * bt;
  int* unsat = reinterpret_cast<int*>(smem);  // [2][bt], by iteration parity
  uint8_t* A = smem + 2 * sizeof(int) * bt;   // CN view [n_edges][bt]
  uint8_t* B = A + p.n_edges * bt;            // VN view [n_edges][bt]
  uint8_t* CHG = B + p.n_edges * bt;          // channel [n_vars][bt]
  uint8_t* TC = CHG + p.n_vars * bt;          // CN LUTs of this iteration
  uint8_t* TV = TC + p.n_cn_slots * p.slot;   // VN LUTs of this iteration
  uint8_t* MC = TV + p.n_vn_slots * p.slot;   // CN alignment rows
  uint8_t* MV = MC + p.d_c_max * p.t_decoder; // VN alignment rows

  const int cn_stage = p.n_cn_slots * p.slot;
  const int vn_stage = p.n_vn_slots * p.slot;
  const int mc_stage = p.d_c_max * p.t_decoder;
  const int mv_stage = p.d_v_max * p.t_decoder;
  const Luts cn_lut0{TC, p.slot, p.t_channel};  // iteration-0 tables: [.., Tch]
  const Luts cn_lut{TC, p.slot, p.t_decoder};
  const Luts vn_lut{TV, p.slot, p.t_decoder};
  const ib_lut::Graph g{p.cn_groups,   p.vn_groups,   p.cn_route, p.vn_route, p.node_var,
                        p.n_cn_groups, p.n_vn_groups, bt,         p.t_decoder};
  const int t0 = threadIdx.x, step = blockDim.x;

  // Seed: CN view <- channel cluster of each row's variable; CHG <- the
  // channel cluster of each group-ordered variable node. Padding columns 0.
  for (int t = threadIdx.x; t < p.n_edges * bt; t += blockDim.x) {
    const int r = t / bt, col = b0 + t - r * bt;
    A[t] = col < p.batch
               ? uint8_t(p.clusters[size_t(__ldg(&p.seed_var[r])) * p.batch + col])
               : uint8_t(0);
  }
  for (int t = threadIdx.x; t < p.n_vars * bt; t += blockDim.x) {
    const int r = t / bt, col = b0 + t - r * bt;
    CHG[t] = col < p.batch
                 ? uint8_t(p.clusters[size_t(__ldg(&p.node_var[r])) * p.batch + col])
                 : uint8_t(0);
  }
  stage(TC, p.cn_tab, cn_stage);
  stage(MC, p.match_cn, mc_stage);
  __syncthreads();
  ib_lut::cn_pass(g, A, B, cn_lut0, MC, nullptr, t0, step);
  __syncthreads();

  int iters = 0;
  for (int i = 0; i < p.imax - 1; ++i) {
    int* u = unsat + (i & 1) * bt;
    stage(TV, p.vn_tab + size_t(i) * vn_stage, vn_stage);
    stage(MV, p.match_vn + size_t(i) * mv_stage, mv_stage);
    stage(TC, p.cn_tab + size_t(i + 1) * cn_stage, cn_stage);
    stage(MC, p.match_cn + size_t(i + 1) * mc_stage, mc_stage);
    for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
    __syncthreads();
    ib_lut::vn_pass(g, B, A, CHG, vn_lut, MV, t0, step);
    __syncthreads();
    ib_lut::cn_pass(g, A, B, cn_lut, MC, u, t0, step);
    __syncthreads();
    iters = i + 1;
    if (p.early_exit) {
      // Every thread reads the same counts: the exit is uniform.
      bool any = false;
      for (int c = 0; c < bt; ++c) any |= u[c] > 0;
      if (!any) break;
    }
  }

  stage(TV, p.vn_tab + size_t(iters) * vn_stage, vn_stage);
  __syncthreads();
  ib_lut::decide_pass(g, B, CHG, vn_lut, p.outputs, b0, p.batch, t0, step);
  for (int c = threadIdx.x; c < bt; c += blockDim.x) {
    if (b0 + c >= p.batch) continue;
    p.unsat_out[b0 + c] = iters == 0 ? 1 : unsat[((iters - 1) & 1) * bt + c];
    p.iters_out[b0 + c] = iters;
  }
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt`, one CTA per tile, on `stream`.
// Returns the cudaError_t of the attribute call or of the launch.
int ib_lut_fused_decode(const int32_t* clusters, int32_t* outputs, int32_t* unsat_out,
                        int32_t* iters_out, const uint8_t* cn_tab, const uint8_t* vn_tab,
                        const uint8_t* match_cn, const uint8_t* match_vn,
                        const int32_t* seed_var, const int32_t* node_var,
                        const int32_t* cn_route, const int32_t* vn_route,
                        const int32_t* cn_groups, const int32_t* vn_groups,
                        int n_cn_groups, int n_vn_groups, int n_vars, int n_edges,
                        int batch, int bt, int t_channel, int t_decoder,
                        int n_cn_slots, int n_vn_slots, int slot, int d_c_max,
                        int d_v_max, int imax, int early_exit, void* stream) {
  Params p{clusters,    outputs,     unsat_out, iters_out, cn_tab,     vn_tab,
           match_cn,    match_vn,    seed_var,  node_var,  cn_route,   vn_route,
           cn_groups,   vn_groups,   n_cn_groups, n_vn_groups, n_vars, n_edges,
           batch,       bt,          t_channel, t_decoder, n_cn_slots, n_vn_slots,
           slot,        d_c_max,     d_v_max,   imax,      early_exit};
  const size_t smem = shared_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      ib_lut_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int grid = (batch + bt - 1) / bt;
  ib_lut_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

int ib_lut_fused_max_degree() { return kMaxDegree; }

const char* ib_lut_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
