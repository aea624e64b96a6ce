// K2: fused float (min-sum / BP) LDPC decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/float_fused.py:_build_float_fused_kernel. It computes what that
// kernel computes, not how: one CTA decodes one tile of `bt` codewords from
// channel LLRs to posterior LLRs with both float32 message views resident in
// shared memory, so no message touches device memory during the decode.
//
// Per tile:
//   seed the CN view A with each row's channel LLR and cache each variable
//   node's channel LLR in group order (CHG);
//   loop, at most imax-1 bodies: CN leave-one-out A -> B (min-sum: min1/min2
//   with leave-one-out signs; BP: pairwise box-plus prefix/suffix), routed on
//   write; VN update clip(ch + sum - m_j, +-150) B -> A, routed on write;
//   syndrome of A (hard bit A < 0) counted per codeword; the tile leaves the
//   loop when no codeword has an unsatisfied check (early exit);
//   imax <= 1 runs no body: the syndrome of the seeded A and a zero B;
//   decision ch + left-fold sum of B, unclamped, written straight to the
//   natural variable index; unsat and iters per codeword.
//
// Semantics match decode/float_common.py (the plain twin) and the JAX
// decoders: the same fold orders, and every add, subtract and multiply is
// an explicitly rounded intrinsic, so nvcc cannot contract or reorder them
// into something torch's elementwise kernels do not compute. Min-sum is exact
// up to the sign of a zero; BP uses expf and log1pf (no fast math). Padding
// columns of the last tile hold LLR 0 and take part in that tile's exit test.
// The node rules live in float_groups.cuh, which K4 (float_hbm.cu) shares.
//
// What bounds it on this card (counts from shapes, not measurements): one
// CTA per SM, set by shared memory. On WLAN N=1296 a codeword needs
// (2*4644 + 1296)*4 B = 42,336 B, so a tile is 5 codewords (211.7 KB of the
// 227 KB). Each body reads and writes both views, 4*4644*4 B = 74.3 KB per
// codeword, plus 18.6 KB for the syndrome pass over A and 5.2 KB of channel
// reads; the routed writes scatter, so they meet bank conflicts. BP adds
// 3(d-2) box-plus operations per check, 10,044 per WLAN codeword and body,
// each with two expf and two log1pf: about 40k transcendental calls per
// codeword per body. Device memory carries only the LLRs in and the
// posteriors out. The design is the simple one: one thread per
// (node, codeword) item, strided over 1024 threads, a node's inputs held in
// registers (the degree is a template parameter), and block-wide barriers
// between the passes. Folding the syndrome into the VN writes, and larger or
// half-precision tiles, are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "float_groups.cuh"

namespace {

// 1024 threads measured faster than 512 for K1 on the same card;
// __launch_bounds__ then caps registers at 64.
constexpr int kThreads = 1024;
constexpr int kMaxDegree = 16;
using float_llr::kBP;
using float_llr::kMinSum;

struct Params {
  const float* llrs;         // [n_vars, batch]
  float* outputs;            // [n_vars, batch]
  int32_t* unsat_out;        // [batch]
  int32_t* iters_out;        // [batch]
  const int32_t* seed_var;   // [n_edges] variable of each CN-view row
  const int32_t* node_var;   // [n_vars] variable of each group-ordered VN
  const int32_t* cn_route;   // [n_edges] CN-view row -> VN-view row
  const int32_t* vn_route;   // [n_edges] VN-view row -> CN-view row
  const int32_t* cn_groups;  // [n_cn_groups, 3] (offset, num_nodes, degree)
  const int32_t* vn_groups;  // [n_vn_groups, 4] (offset, num_nodes, degree, node offset)
  int n_cn_groups, n_vn_groups;
  int n_vars, n_edges, batch, bt;
  int imax, early_exit;
};

// Shared-memory carve; float_fused.py:shared_bytes mirrors it.
__host__ __device__ inline size_t shared_bytes(const Params& p) {
  return 2 * sizeof(int) * p.bt  // unsat counts, 2 buffers
         + sizeof(float) * size_t(2 * p.n_edges + p.n_vars) * p.bt;  // A, B, CHG
}

template <int RULE>
__global__ void __launch_bounds__(kThreads) float_fused_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bt = p.bt;
  const int b0 = blockIdx.x * bt;
  int* unsat = reinterpret_cast<int*>(smem);  // [2][bt], by body parity
  float* A = reinterpret_cast<float*>(smem + 2 * sizeof(int) * bt);  // CN view
  float* B = A + size_t(p.n_edges) * bt;                             // VN view
  float* CHG = B + size_t(p.n_edges) * bt;  // channel LLR per group-ordered VN
  const float_llr::Graph g{p.cn_groups,   p.vn_groups,   p.cn_route, p.vn_route,
                          p.node_var,    p.n_cn_groups, p.n_vn_groups, bt};
  const int t0 = threadIdx.x, step = blockDim.x;

  // Seed: A <- channel LLR of each row's variable; CHG <- channel LLR of each
  // group-ordered variable node. Padding columns 0.
  for (int t = threadIdx.x; t < p.n_edges * bt; t += blockDim.x) {
    const int r = t / bt, col = b0 + t - r * bt;
    A[t] = col < p.batch ? p.llrs[size_t(__ldg(&p.seed_var[r])) * p.batch + col] : 0.f;
  }
  for (int t = threadIdx.x; t < p.n_vars * bt; t += blockDim.x) {
    const int r = t / bt, col = b0 + t - r * bt;
    CHG[t] = col < p.batch ? p.llrs[size_t(__ldg(&p.node_var[r])) * p.batch + col] : 0.f;
  }

  int iters = 0;
  const int* last = unsat;  // the counts reported per codeword
  if (p.imax <= 1) {
    // No body runs: the syndrome of the seeded view and a zero VN view.
    for (int c = threadIdx.x; c < bt; c += blockDim.x) unsat[c] = 0;
    for (int t = threadIdx.x; t < p.n_edges * bt; t += blockDim.x) B[t] = 0.f;
    __syncthreads();
    float_llr::syndrome_pass(g, A, unsat, t0, step);
    __syncthreads();
  } else {
    __syncthreads();
    for (int i = 0; i < p.imax - 1; ++i) {
      int* u = unsat + (i & 1) * bt;
      // Without early exit only the last body's syndrome is reported.
      const bool count = p.early_exit || i == p.imax - 2;
      if (count)
        for (int c = threadIdx.x; c < bt; c += blockDim.x) u[c] = 0;
      float_llr::cn_pass<RULE>(g, A, B, t0, step);
      __syncthreads();
      float_llr::vn_pass(g, B, A, CHG, t0, step);
      __syncthreads();
      iters = i + 1;
      if (count) {
        float_llr::syndrome_pass(g, A, u, t0, step);
        __syncthreads();
        last = u;
        if (p.early_exit) {
          // Every thread reads the same counts: the exit is uniform.
          bool any = false;
          for (int c = 0; c < bt; ++c) any |= u[c] > 0;
          if (!any) break;
        }
      }
    }
  }

  float_llr::decide_pass(g, B, CHG, p.outputs, b0, p.batch, t0, step);
  for (int c = threadIdx.x; c < bt; c += blockDim.x) {
    if (b0 + c >= p.batch) continue;
    p.unsat_out[b0 + c] = last[c];
    p.iters_out[b0 + c] = iters;
  }
}

template <int RULE>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = shared_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      float_fused_kernel<RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int grid = (p.batch + p.bt - 1) / p.bt;
  float_fused_kernel<RULE><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt`, one CTA per tile, on `stream`,
// with the min-sum (rule 0) or BP (rule 1) check update. Returns the
// cudaError_t of the attribute call or of the launch.
int float_fused_decode(int rule, const float* llrs, float* outputs, int32_t* unsat_out,
                       int32_t* iters_out, const int32_t* seed_var, const int32_t* node_var,
                       const int32_t* cn_route, const int32_t* vn_route,
                       const int32_t* cn_groups, const int32_t* vn_groups,
                       int n_cn_groups, int n_vn_groups, int n_vars, int n_edges,
                       int batch, int bt, int imax, int early_exit, void* stream) {
  Params p{llrs,     outputs,  unsat_out, iters_out,   seed_var,    node_var,
           cn_route, vn_route, cn_groups, vn_groups,   n_cn_groups, n_vn_groups,
           n_vars,   n_edges,  batch,     bt,          imax,        early_exit};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rule == kMinSum) return launch<kMinSum>(p, s);
  if (rule == kBP) return launch<kBP>(p, s);
  return int(cudaErrorInvalidValue);
}

int float_fused_max_degree() { return kMaxDegree; }

const char* float_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
