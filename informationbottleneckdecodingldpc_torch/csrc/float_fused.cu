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
//   per body i = 0 .. imax-2:
//     CN pass: leave-one-out A -> B (min-sum: min1/min2 with leave-one-out
//       signs; BP: pairwise box-plus prefix/suffix), routed on write. Each
//       item also takes the parity of its inputs' signs, the syndrome test
//       (hard bit A < 0) of A after body i-1;
//     with early exit and i >= 1, the barrier after the CN pass ORs those
//       parities over the block (__syncthreads_or): if no check of any
//       codeword is unsatisfied, the tile leaves with iters = i and unsat 0;
//     VN pass: clip(ch + sum - m_j, +-150) B -> A, routed on write. Its
//       totals ch + ((m0 + m1) + ...) are the decision of body i, written to
//       the tile's slab of a totals plane in device memory (with early exit
//       every body, since any body may be the last; without it only the
//       last body), so a tile that leaves after body i already holds body
//       i's decision;
//   after the last body, one parity-only pass over A counts the unsatisfied
//   checks per codeword: the reported counts, iters = imax-1;
//   imax <= 1 runs no body: the parity pass over the seeded A, and the
//   decision ch + 0 (a zero B);
//   the decision goes from the slab to the natural variable index of the
//   output plane; unsat and iters per codeword.
// Padding columns of the last tile hold LLR 0, take part in the exit test
// and write no output.
//
// Semantics match decode/float_common.py (the plain twin) and the JAX
// decoders: the same fold orders, and every add, subtract and multiply is
// an explicitly rounded intrinsic, so nvcc cannot contract or reorder them
// into something torch's elementwise kernels do not compute. Min-sum is exact
// up to the sign of a zero; BP uses expf and log1pf (no fast math). The node
// rules live in float_groups.cuh, which K4 (float_hbm.cu) shares.
//
// What bounds it on this card. One CTA per SM, set by shared memory: on WLAN
// N=1296 a codeword needs (2*4644 + 1296)*4 B = 42,336 B, so a tile is 5
// codewords (211.7 KB of the 227 KB); regular N=8000 takes one. Shared-memory
// bandwidth is not the limit: a min-sum body moves about 98 KB per WLAN
// codeword, 0.59 ms of the previous design's 2.87 ms decode at batch 4096
// (128 B per clock and SM). The previous design lost its time to work around
// the node rules (NVIDIA H100 80GB HBM3, 700 W): with early exit, a syndrome
// pass re-reading A every body (about 29% of a 58.5 us min-sum body), a
// decision pass re-reading B, a runtime division per item in every pass,
// each degree group strided on its own over the threads (WLAN's 540
// degree-7 and 108 degree-8 checks x 5 columns took 3 + 1 rounds of 1024
// threads where 3.2 do), and three block-wide barriers a body that drain the
// SM's only CTA. BP adds 3(d-2)
// box-plus operations per check, 10,044 per WLAN codeword and body, each two
// expf and two log1pf calls: K5c's box-plus chain runs them at about 274 G/s,
// which alone takes about 7.35 ms of a BP decode at batch 4096 and 49 bodies.
//
// The design does about it: the syndrome rides in the CN pass and the
// decision in the VN pass, so a body has two passes and two barriers; a block
// runs q * bt threads (q = kThreads / bt), so each thread keeps one codeword
// column c = threadIdx.x % bt for the whole decode and its node advances by
// the constant q, with no division per item; and each pass walks its nodes
// in one flat sequence over all degree groups, so a group's tail does not
// leave the other threads idle (a thread's node carries from one group to
// the next). Reads are contiguous per warp (consecutive items are
// consecutive words of a view row); writes are routed and scatter. The
// totals slab is [n_vars][bt] in group order, like CHG, so a warp writes it
// in whole lines (written straight to the output plane's rows, 4 bytes per
// codeword apart on regular N=8000, they made an early-exit decode slower
// than the previous design's), and a thread's final copy reads back only what
// it wrote itself. Threads per CTA are chosen per rule from ptxas, the most
// that do not spill: min-sum 1024 (64 registers), BP 640 (96 registers; at
// 1024 and 768 threads its fold spills). On the same card this design
// decodes WLAN at batch 4096, 49 bodies, in 2.449 ms (min-sum) and 7.973 ms
// (BP), 1.473 and 3.024 ms with early exit at 2.0 dB (chip_smoke.py phase
// 10): min-sum 14% faster than the previous design, 30% with early exit;
// BP stays near its box-plus chain's 7.2 ms (K5c's rate).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "float_groups.cuh"

namespace {

constexpr int kMaxDegree = 16;
using float_llr::kBP;
using float_llr::kMinSum;
template <int RULE>
constexpr int kThreads = RULE == kMinSum ? 1024 : 640;

struct Params {
  const float* llrs;         // [n_vars, batch]
  float* outputs;            // [n_vars, batch]
  float* totals;             // [tiles][n_vars][bt] decision in group order
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
  return sizeof(int) * p.bt  // unsat counts
         + sizeof(float) * size_t(2 * p.n_edges + p.n_vars) * p.bt;  // A, B, CHG
}

// A thread's place in every pass: its codeword column `c` and first node
// `node0`; it steps `q` nodes at a time. Node n of a pass is the n-th node of
// its groups taken in order, so item (n, c) is word n * bt + c of a view
// slab whose rows are the pass's nodes.
struct Walk {
  int node0, q, c;
};

// One check node of degree D at local index `ln` of its group (rows off + k
// * n + ln): min-sum leave-one-out, routed into dst; returns the parity of its
// inputs' signs.
template <int D>
__device__ __forceinline__ int cn_minsum_item(const float* __restrict__ src,
                                              float* __restrict__ dst,
                                              const int32_t* __restrict__ route, int off,
                                              int n, int ln, int bt, int c) {
  const float* in = src + (off + ln) * bt + c;  // message k at in[k * n * bt]
  const int32_t* rt = route + off + ln;         // its route at rt[k * n]
  float m[D];
#pragma unroll
  for (int k = 0; k < D; ++k) m[k] = in[k * n * bt];
  float out[D];
  const int odd = float_llr::minsum_fold<D>(m, out);
#pragma unroll
  for (int k = 0; k < D; ++k) dst[__ldg(&rt[k * n]) * bt + c] = out[k];
  return odd;
}

// The same for BP: the pairwise box-plus fold of float_ops.py
// associative_leave_one_out. suf[k] = fold(m_k..m_{D-1}) = m_k [+] suf[k+1];
// out_0 = suf[1], out_j = pre_{j-1} [+] suf[j+1], out_{D-1} = pre_{D-2},
// with pre_j = pre_{j-1} [+] m_j. Inputs are read again from the view in the
// forward walk, so only the suffixes live in registers.
template <int D>
__device__ __forceinline__ int cn_bp_item(const float* __restrict__ src, float* __restrict__ dst,
                                          const int32_t* __restrict__ route, int off, int n,
                                          int ln, int bt, int c) {
  const float* in = src + (off + ln) * bt + c;
  const int32_t* rt = route + off + ln;
  const int nbt = n * bt;
  if constexpr (D == 2) {
    const float m0 = in[0], m1 = in[nbt];
    dst[__ldg(&rt[0]) * bt + c] = m1;
    dst[__ldg(&rt[n]) * bt + c] = m0;
    return (m0 < 0.f) ^ (m1 < 0.f);
  } else {
    float suf[D];
    suf[D - 1] = in[(D - 1) * nbt];
#pragma unroll
    for (int k = D - 2; k >= 1; --k) suf[k] = float_llr::boxplus(in[k * nbt], suf[k + 1]);
    dst[__ldg(&rt[0]) * bt + c] = suf[1];
    float pre = in[0];
    // The parity is taken in the forward walk, as the suffixes free their
    // registers.
    int odd = (pre < 0.f) ^ (suf[D - 1] < 0.f);
#pragma unroll
    for (int j = 1; j < D - 1; ++j) {
      dst[__ldg(&rt[j * n]) * bt + c] = float_llr::boxplus(pre, suf[j + 1]);
      const float m = in[j * nbt];
      odd ^= m < 0.f;
      pre = float_llr::boxplus(pre, m);
    }
    dst[__ldg(&rt[(D - 1) * n]) * bt + c] = pre;
    return odd;
  }
}

// One variable node of degree D: total = ch + ((m0 + m1) + m2 ...), out_j =
// clip(total - m_j); degree 1 forwards clip(ch). With `decide`, the total
// (degree 1: ch + m0) goes to `*tot`.
template <int D>
__device__ __forceinline__ void vn_item(const float* __restrict__ src, float* __restrict__ dst,
                                        const int32_t* __restrict__ route, float ch, int off,
                                        int n, int ln, int bt, int c, float* tot, bool decide) {
  const float* in = src + (off + ln) * bt + c;
  const int32_t* rt = route + off + ln;
  if constexpr (D == 1) {
    dst[__ldg(&rt[0]) * bt + c] = float_llr::clip_llr(ch);
    if (decide) *tot = __fadd_rn(ch, in[0]);
  } else {
    float m[D];
#pragma unroll
    for (int k = 0; k < D; ++k) m[k] = in[k * n * bt];
    const float total = float_llr::vn_total<D>(ch, m);
#pragma unroll
    for (int k = 0; k < D; ++k)
      dst[__ldg(&rt[k * n]) * bt + c] = float_llr::clip_llr(__fsub_rn(total, m[k]));
    if (decide) *tot = total;
  }
}

#define FLOAT_DEGREES_2_TO_16(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// CN pass A -> B over every check group; returns whether any of this
// thread's checks has inputs of odd sign parity.
template <int RULE>
__device__ bool cn_pass(const Params& p, const float* A, float* B, Walk w) {
  int odd = 0, node = w.node0, first = 0;  // `first`: the group's first node
  for (int k = 0; k < p.n_cn_groups; ++k) {
    const int off = p.cn_groups[3 * k], n = p.cn_groups[3 * k + 1], end = first + n;
    switch (p.cn_groups[3 * k + 2]) {
#define FLOAT_CN_CASE(D)                                                                  \
  case D:                                                                                 \
    for (; node < end; node += w.q)                                                       \
      if constexpr (RULE == kMinSum)                                                      \
        odd |= cn_minsum_item<D>(A, B, p.cn_route, off, n, node - first, p.bt, w.c);      \
      else                                                                                \
        odd |= cn_bp_item<D>(A, B, p.cn_route, off, n, node - first, p.bt, w.c);          \
    break;
      FLOAT_DEGREES_2_TO_16(FLOAT_CN_CASE)
#undef FLOAT_CN_CASE
      default:
        __trap();
    }
    first = end;
  }
  return odd;
}

// The tile's slab of the totals plane: [n_vars][bt] in group order, like CHG.
__device__ __forceinline__ float* tile_totals(const Params& p) {
  return p.totals + size_t(blockIdx.x) * p.n_vars * p.bt;
}

// VN pass B -> A over every variable group, with the channel LLRs `chg`
// ([n_vars][bt], group order); with `decide`, the totals go to the tile's
// slab of the totals plane.
__device__ void vn_pass(const Params& p, const float* B, float* A, const float* chg, Walk w,
                        bool decide) {
  float* tot = tile_totals(p);
  int node = w.node0;
  for (int k = 0; k < p.n_vn_groups; ++k) {
    const int off = p.vn_groups[4 * k], n = p.vn_groups[4 * k + 1];
    const int first = p.vn_groups[4 * k + 3], end = first + n;
    switch (p.vn_groups[4 * k + 2]) {
#define FLOAT_VN_CASE(D)                                                                   \
  case D:                                                                                  \
    for (; node < end; node += w.q)                                                        \
      vn_item<D>(B, A, p.vn_route, chg[node * p.bt + w.c], off, n, node - first, p.bt,     \
                 w.c, tot + node * p.bt + w.c, decide);                                    \
    break;
      FLOAT_VN_CASE(1)
      FLOAT_DEGREES_2_TO_16(FLOAT_VN_CASE)
#undef FLOAT_VN_CASE
      default:
        __trap();
    }
  }
}

// Parity-only pass over A: per codeword, the checks whose inputs hold an odd
// number of negative values, added into unsat[c]. (K4's syndrome_pass does
// the same with a division per item and costs BP a spilled register here.)
__device__ void parity_pass(const Params& p, const float* A, int* unsat, Walk w) {
  int count = 0, node = w.node0, first = 0;
  for (int k = 0; k < p.n_cn_groups; ++k) {
    const int off = p.cn_groups[3 * k], n = p.cn_groups[3 * k + 1];
    const int d = p.cn_groups[3 * k + 2], end = first + n;
    for (; node < end; node += w.q) {
      const float* in = A + (off + node - first) * p.bt + w.c;
      int odd = 0;
      for (int j = 0; j < d; ++j) odd ^= in[j * n * p.bt] < 0.f;
      count += odd;
    }
    first = end;
  }
  if (count) atomicAdd(&unsat[w.c], count);
}

template <int RULE>
__global__ void __launch_bounds__(kThreads<RULE>) float_fused_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bt = p.bt;
  const int b0 = blockIdx.x * bt;
  int* unsat = reinterpret_cast<int*>(smem);  // [bt]
  float* A = reinterpret_cast<float*>(smem + sizeof(int) * bt);  // CN view
  float* B = A + size_t(p.n_edges) * bt;                         // VN view
  float* CHG = B + size_t(p.n_edges) * bt;  // channel LLR per group-ordered VN
  // The launch has q * bt threads: one division per thread and launch.
  const Walk w{int(threadIdx.x) / bt, int(blockDim.x) / bt, int(threadIdx.x) % bt};
  const int col = b0 + w.c;
  const bool real = col < p.batch;  // padding columns read 0 and write no output

  // Seed: A <- channel LLR of each row's variable; CHG <- channel LLR of each
  // group-ordered variable node. Padding columns 0.
  for (int r = w.node0; r < p.n_edges; r += w.q)
    A[r * bt + w.c] = real ? p.llrs[size_t(__ldg(&p.seed_var[r])) * p.batch + col] : 0.f;
  for (int r = w.node0; r < p.n_vars; r += w.q)
    CHG[r * bt + w.c] = real ? p.llrs[size_t(__ldg(&p.node_var[r])) * p.batch + col] : 0.f;
  if (threadIdx.x < bt) unsat[threadIdx.x] = 0;
  __syncthreads();

  const int bodies = p.imax > 1 ? p.imax - 1 : 0;
  int iters = bodies;
  bool left = false;
  for (int i = 0; i < bodies; ++i) {
    const bool odd = cn_pass<RULE>(p, A, B, w);
    if (p.early_exit && i > 0) {
      // The parities are those of A after body i-1. The predicate is OR-ed
      // over the block, so every thread takes the same branch.
      if (!__syncthreads_or(odd)) {
        iters = i;
        left = true;
        break;
      }
    } else {
      __syncthreads();
    }
    vn_pass(p, B, A, CHG, w, p.early_exit || i == bodies - 1);
    __syncthreads();
  }
  if (!left) {
    parity_pass(p, A, unsat, w);
    __syncthreads();
  }
  // The decision to the natural variable index: the totals of the tile's
  // last body, which this thread wrote itself (the VN pass walks the same
  // nodes), or ch + 0 when no body ran.
  const float* tot = tile_totals(p);
  if (real)
    for (int r = w.node0; r < p.n_vars; r += w.q)
      p.outputs[size_t(__ldg(&p.node_var[r])) * p.batch + col] =
          bodies ? tot[r * bt + w.c] : __fadd_rn(CHG[r * bt + w.c], 0.f);
  if (threadIdx.x < bt && b0 + int(threadIdx.x) < p.batch) {
    p.unsat_out[b0 + threadIdx.x] = unsat[threadIdx.x];
    p.iters_out[b0 + threadIdx.x] = iters;
  }
}

template <int RULE>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = shared_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      float_fused_kernel<RULE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (p.bt < 1 || p.bt > kThreads<RULE>) return int(cudaErrorInvalidValue);
  const int grid = (p.batch + p.bt - 1) / p.bt;
  float_fused_kernel<RULE><<<grid, (kThreads<RULE> / p.bt) * p.bt, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt`, one CTA per tile, on `stream`,
// with the min-sum (rule 0) or BP (rule 1) check update; `totals` is the
// caller's scratch of ceil(batch / bt) * n_vars * bt floats. Returns the
// cudaError_t of the attribute call or of the launch.
int float_fused_decode(int rule, const float* llrs, float* outputs, float* totals,
                       int32_t* unsat_out, int32_t* iters_out, const int32_t* seed_var,
                       const int32_t* node_var,
                       const int32_t* cn_route, const int32_t* vn_route,
                       const int32_t* cn_groups, const int32_t* vn_groups,
                       int n_cn_groups, int n_vn_groups, int n_vars, int n_edges,
                       int batch, int bt, int imax, int early_exit, void* stream) {
  Params p{llrs,      outputs,     totals,      unsat_out, iters_out, seed_var,
           node_var,  cn_route,    vn_route,    cn_groups, vn_groups, n_cn_groups,
           n_vn_groups, n_vars,    n_edges,     batch,     bt,        imax,
           early_exit};
  const auto s = static_cast<cudaStream_t>(stream);
  if (rule == kMinSum) return launch<kMinSum>(p, s);
  if (rule == kBP) return launch<kBP>(p, s);
  return int(cudaErrorInvalidValue);
}

int float_fused_max_degree() { return kMaxDegree; }
int float_fused_threads_minsum() { return kThreads<kMinSum>; }
int float_fused_threads_bp() { return kThreads<kBP>; }

const char* float_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
