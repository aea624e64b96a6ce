// K1: fused IB lookup-table LDPC decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel informationbottleneckdecodingldpc_tpu/
// kernels/ib_lut_fused.py:_build_kernel. It computes what that kernel
// computes, not how: one CTA decodes one tile of `bt` codewords from channel
// clusters to decisions with both message views resident in shared memory,
// so no message touches device memory during the decode.
//
// Per tile:
//   seed the CN view A from the channel clusters and cache each variable
//   node's channel cluster (CHG, group order); stage the routes;
//   iteration-0 CN leave-one-out with the iteration-0 tables and
//   matching_cn[0], routed on write into the VN view B;
//   body i = 0 .. imax-2: VN leave-one-out with vn_first[i]/vn_rest[i] and
//   matching_vn[i], B -> A; CN leave-one-out with cn_rest[i] and
//   matching_cn[i+1], A -> B, counting per codeword the checks whose inputs
//   (the VN -> CN messages) have odd hard-bit parity; with early exit the
//   barrier after the CN pass ORs those counts over the block
//   (__syncthreads_or), and the tile leaves when no check of any codeword is
//   unsatisfied;
//   decision fold with the VN tables of iteration `iters`, written straight
//   to the natural variable index; unsat and iters per codeword.
//
// Semantics match the JAX decoder bit for bit (ops/lut_fold.py contract):
// every node output is a strict left-to-right fold of its input sequence
// with the own edge removed, step p through pairwise LUT p-1 indexed
// lut[state][next] (ib_lut_groups.cuh cn_fold / vn_fold). These position-
// indexed tables are not associative, so outputs share prefixes and no
// suffix. Padding columns of the last tile hold cluster 0 and take part in
// the tile's exit test, as in the JAX kernel.
//
// What bounds it on this card. One CTA per SM, set by shared memory (WLAN
// N=1296 at 16 codewords: 169,344 B of views and channel, 18,576 B of
// routes, 4,656 B of tables and rows). Device memory sees only the clusters
// in and the decisions out. The work is chains of dependent byte lookups in
// shared memory: a WLAN |T|=16 body makes 40,986 lookups per codeword
// (31,698 pairwise, 9,288 alignment), which at one warp-wide access per
// clock and SM bound a batch-4096, 49-body decode at 0.9965 ms. The previous
// design (one thread per (node, codeword), 3.1517 ms there on an NVIDIA H100
// 80GB HBM3 at 700 W) ran at a third of that, held by the latency of its
// chains rather than by the pipe: a thread had one column's chain in flight,
// and routes, a runtime division and a partial round per degree group sat
// around it. What the design does about each candidate:
//   (1) routes: staged once per tile into shared memory as uint16 where they
//       fit beside the views (WLAN |T|=16 and 32: 18,576 B), so no route is
//       read from device memory inside an iteration; on regular N=8000
//       (tile 4: 192,000 B of views, 96,000 B of routes) they do not fit and
//       are read from device memory as int32 (nibble-packed views would make
//       room; not needed elsewhere, not done);
//   (2)+(3) division and rounds: a block runs q * (bt / V) threads; a
//       thread keeps V codeword columns c0 .. c0+V-1 for the whole decode
//       and steps q nodes at a time, flat over all degree groups of a pass
//       (its node carries from one group to the next), with no division per
//       item. Splitting WLAN's degree-11 variable nodes into two items (each
//       recomputing its prefix) was measured and lost: the tail it removes
//       costs less than the lookups and loads it adds;
//   (4) bank conflicts: the tables stay one byte copy per block. Nibble-
//       packed tables at |T| <= 16 (128 B, one word per bank, conflict-free)
//       lost to them once each thread had four chains in flight: their
//       extraction lengthens every chain step more than the conflicts cost.
//       At |T|=32 a second table copy per half-warp lost too;
//   (5) wider work: V = 4 columns per thread where 4 divides the tile (else
//       1). A message row is one 32-bit load, a routed output one 32-bit
//       store, a route read once per four columns, and the four columns'
//       folds are unrolled side by side, four independent chains per thread.
//       This is what moved K1 most. Threads per CTA are the most at which no
//       instantiation spills (chip_smoke.py phase 2 prints ptxas's lines):
//       640 at V = 4 (96 registers; 768 spill), 1024 at V = 1.
// Two barriers a body: the next pass's tables are staged during the pass
// before it, and the exit test is the barrier after the CN pass.
// On the same card (cli/kernel_times.py, the previous design in the same
// call): WLAN |T|=16 at batch 4096, 49 bodies, 3.1476 -> 2.4400 ms (2.45x
// the lookup bound; the chains' latency and the byte tables' conflicts,
// not measured apart, hold it now); at 2.4 dB with early exit 2.6577 ->
// 1.8386 ms; WLAN
// |T|=32 at batch 2048 2.2974 -> 2.0302 ms; regular N=8000 at batch 512,
// tile 4, i_max 250 8.6143 -> 5.6651 ms.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "ib_lut_groups.cuh"

namespace {

constexpr int kMaxDegree = 16;
constexpr size_t kMaxShared = 232448;  // ib_lut_fused.py:MAX_SHARED_BYTES
// Threads per CTA at V columns per thread: the most at which ptxas spills
// nothing (V = 4: 96 registers; 768 threads, 80 registers, spill).
template <int V>
constexpr int kThreads = V == 4 ? 640 : 1024;

struct Params {
  const int32_t* clusters;    // [n_vars, batch]
  int32_t* outputs;           // [n_vars, batch]
  int32_t* unsat_out;         // [batch]
  int32_t* iters_out;         // [batch]
  const uint8_t* cn_tab;      // [i_max, n_cn_slots, slot]: CN LUTs per DE iteration
  const uint8_t* vn_tab;      // [i_max, n_vn_slots, slot]: vn_first, vn_rest...
  const uint8_t* match_cn;    // [i_max, d_c_max, T]
  const uint8_t* match_vn;    // [i_max, d_v_max, T]
  const int32_t* seed_var;    // [n_edges] variable of each CN-view row
  const int32_t* node_var;    // [n_vars] variable of each group-ordered VN
  const int32_t* cn_route;    // [n_edges] CN-view row -> VN-view row
  const int32_t* vn_route;    // [n_edges] VN-view row -> CN-view row
  const uint16_t* cn_route16; // the same as uint16 (null if n_edges > 65536)
  const uint16_t* vn_route16;
  const int32_t* cn_groups;   // [n_cn_groups, 3] (offset, num_nodes, degree)
  const int32_t* vn_groups;   // [n_vn_groups, 4] (offset, num_nodes, degree, node offset)
  int n_cn_groups, n_vn_groups;
  int n_vars, n_edges, batch, bt;
  int t_channel, t_decoder;
  int n_cn_slots, n_vn_slots, slot;
  int d_c_max, d_v_max;
  int imax, early_exit;
};

// Shared-memory carve without the routes (ib_lut_fused.py:shared_bytes, the
// tile rule's): unsat counts (2 buffers), views A, B and the channel, one
// iteration's tables and alignment rows.
__host__ __device__ inline size_t carve_bytes(const Params& p) {
  return 2 * sizeof(int) * p.bt + size_t(2 * p.n_edges + p.n_vars) * p.bt
         + size_t(p.n_cn_slots + p.n_vn_slots) * p.slot
         + size_t(p.d_c_max + p.d_v_max) * p.t_decoder;
}

// The uint16 routes follow the carve, 2-byte aligned.
__host__ __device__ inline size_t route_offset(const Params& p) {
  return (carve_bytes(p) + 1) / 2 * 2;
}

// Whether the routes are staged into shared memory.
__host__ __device__ inline bool routes_fit(const Params& p) {
  return p.cn_route16 != nullptr && route_offset(p) + 4 * size_t(p.n_edges) <= kMaxShared;
}

// K1's carve; ib_lut_fused.py:kernel_shared_bytes mirrors it.
__host__ __device__ inline size_t shared_bytes(const Params& p) {
  return routes_fit(p) ? route_offset(p) + 4 * size_t(p.n_edges) : carve_bytes(p);
}

// Routes in shared memory (uint16) or device memory (int32).
struct SharedRoutes {
  const uint16_t* r;
  __device__ __forceinline__ int operator[](int i) const { return r[i]; }
};
struct GlobalRoutes {
  const int32_t* r;
  __device__ __forceinline__ int operator[](int i) const { return __ldg(&r[i]); }
};

// V columns of a view row: one byte (V = 1) or one 32-bit word (V = 4).
template <int V>
struct Cols {
  static_assert(V == 1 || V == 4, "1 or 4 columns per thread");
  using W = std::conditional_t<V == 4, uint32_t, uint8_t>;
  static __device__ __forceinline__ W load(const uint8_t* p) {
    return *reinterpret_cast<const W*>(p);
  }
  static __device__ __forceinline__ void store(uint8_t* p, W w) {
    *reinterpret_cast<W*>(p) = w;
  }
  static __device__ __forceinline__ uint8_t get(W w, int v) { return uint8_t(w >> (8 * v)); }
  static __device__ __forceinline__ W put(uint8_t x, int v) { return W(W(x) << (8 * v)); }
};

// A thread's place in every pass: columns c0 .. c0+V-1 and first item
// `item0`; it steps `q` items at a time.
struct Walk {
  int item0, q, c0;
};

// One check node of degree D at local index `ln` of its group, columns c0..:
// leave-one-out, aligned, routed into dst; cnt[v] counts its odd parity.
// The V columns' folds are unrolled side by side: V independent lookup
// chains in flight per thread.
template <int D, int V, class Route>
__device__ __forceinline__ void cn_item(const uint8_t* __restrict__ src,
                                        uint8_t* __restrict__ dst, ib_lut::Luts lut,
                                        const uint8_t* __restrict__ match_row, Route route,
                                        int off, int n, int ln, int bt, int c0, int thresh,
                                        int (&cnt)[V]) {
  using C = Cols<V>;
  typename C::W w[D], o[D];
  const uint8_t* in = src + (off + ln) * bt + c0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    w[k] = C::load(in + k * n * bt);
    o[k] = 0;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    uint8_t m[D], out[D];
    int parity = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      m[k] = C::get(w[k], v);
      parity ^= int(m[k] < thresh);
    }
    cnt[v] += parity;
    ib_lut::cn_fold<D>(m, out, lut);
#pragma unroll
    for (int k = 0; k < D; ++k) o[k] |= C::put(match_row[out[k]], v);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) C::store(dst + route[off + k * n + ln] * bt + c0, o[k]);
}

// One variable node of degree D (channel row `chg_row`), columns c0..:
// leave-one-out, aligned, routed into dst; degree 1 forwards the channel,
// unaligned.
template <int D, int V, class Route>
__device__ __forceinline__ void vn_item(const uint8_t* __restrict__ src,
                                        uint8_t* __restrict__ dst,
                                        const uint8_t* __restrict__ chg_row, ib_lut::Luts lut,
                                        const uint8_t* __restrict__ match_row, Route route,
                                        int off, int n, int ln, int bt, int c0) {
  using C = Cols<V>;
  const typename C::W chw = C::load(chg_row + c0);
  if constexpr (D == 1) {
    C::store(dst + route[off + ln] * bt + c0, chw);
  } else {
    typename C::W w[D], o[D];
    const uint8_t* in = src + (off + ln) * bt + c0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      w[k] = C::load(in + k * n * bt);
      o[k] = 0;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint8_t m[D], out[D];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = C::get(w[k], v);
      ib_lut::vn_fold<D>(C::get(chw, v), m, out, lut);
#pragma unroll
      for (int k = 0; k < D; ++k) o[k] |= C::put(match_row[out[k]], v);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) C::store(dst + route[off + k * n + ln] * bt + c0, o[k]);
  }
}

// CN pass A -> B over every check group, flat: a thread's node carries from
// one group to the next. With `unsat`, adds this thread's odd-parity counts
// per column and returns whether it had any.
template <int V, class Route>
__device__ bool cn_pass(const Params& p, const uint8_t* A, uint8_t* B, ib_lut::Luts lut,
                        const uint8_t* match, Route route, int* unsat, Walk w) {
  int cnt[V] = {};
  int node = w.item0, first = 0;  // `first`: the group's first node
  for (int k = 0; k < p.n_cn_groups; ++k) {
    const int off = p.cn_groups[3 * k], n = p.cn_groups[3 * k + 1];
    const int d = p.cn_groups[3 * k + 2], end = first + n;
    const uint8_t* row = match + (d - 1) * p.t_decoder;
    switch (d) {
#define K1_CN_CASE(D)                                                                   \
  case D:                                                                               \
    for (; node < end; node += w.q)                                                     \
      cn_item<D, V>(A, B, lut, row, route, off, n, node - first, p.bt, w.c0,            \
                    p.t_decoder / 2, cnt);                                              \
    break;
      IB_DEGREES_2_TO_16(K1_CN_CASE)
#undef K1_CN_CASE
      default:
        __trap();
    }
    first = end;
  }
  bool any = false;
  if (unsat != nullptr)
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (cnt[v]) {
        atomicAdd(&unsat[w.c0 + v], cnt[v]);
        any = true;
      }
  return any;
}

// VN pass B -> A over every variable group, flat, with the channel clusters
// `chg` ([n_vars][bt], group order).
template <int V, class Route>
__device__ void vn_pass(const Params& p, const uint8_t* B, uint8_t* A, const uint8_t* chg,
                        ib_lut::Luts lut, const uint8_t* match, Route route, Walk w) {
  const int bt = p.bt;
  int node = w.item0;
  for (int k = 0; k < p.n_vn_groups; ++k) {
    const int off = p.vn_groups[4 * k], n = p.vn_groups[4 * k + 1];
    const int d = p.vn_groups[4 * k + 2], first = p.vn_groups[4 * k + 3], end = first + n;
    const uint8_t* row = match + (d - 1) * p.t_decoder;
    switch (d) {
#define K1_VN_CASE(D)                                                                   \
  case D:                                                                               \
    for (; node < end; node += w.q)                                                     \
      vn_item<D, V>(B, A, chg + node * bt, lut, row, route, off, n, node - first, bt,   \
                    w.c0);                                                              \
    break;
      K1_VN_CASE(1)
      IB_DEGREES_2_TO_16(K1_VN_CASE)
#undef K1_VN_CASE
      default:
        __trap();
    }
  }
}

// Decision fold of every variable node (channel plus all messages), written
// to outputs[var][batch] at the thread's real columns.
template <int V>
__device__ void decide_pass(const Params& p, const uint8_t* B, const uint8_t* chg,
                            ib_lut::Luts lut, int b0, Walk w) {
  using C = Cols<V>;
  const int bt = p.bt;
  int node = w.item0;
  for (int k = 0; k < p.n_vn_groups; ++k) {
    const int off = p.vn_groups[4 * k], n = p.vn_groups[4 * k + 1];
    const int d = p.vn_groups[4 * k + 2], first = p.vn_groups[4 * k + 3], end = first + n;
    for (; node < end; node += w.q) {
      const uint8_t* in = B + (off + node - first) * bt + w.c0;
      const typename C::W chw = C::load(chg + node * bt + w.c0);
      int32_t* out = p.outputs + size_t(__ldg(&p.node_var[node])) * p.batch + b0 + w.c0;
      for (int v = 0; v < V && b0 + w.c0 + v < p.batch; ++v) {
        uint8_t s = lut(0, C::get(chw, v), in[v]);
        for (int j = 1; j < d; ++j) s = lut(j, s, in[j * n * bt + v]);
        out[v] = s;
      }
    }
  }
}

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = __ldg(&src[t]);
}

// The seed rows: row r of `dst` at the thread's columns <- the channel
// cluster of variable var[r] (padding columns 0).
template <int V>
__device__ void seed_rows(const Params& p, uint8_t* dst, const int32_t* __restrict__ var,
                          int rows, int b0, Walk w) {
  using C = Cols<V>;
  for (int r = w.item0; r < rows; r += w.q) {
    const int32_t* x = p.clusters + size_t(__ldg(&var[r])) * p.batch + b0 + w.c0;
    typename C::W word = 0;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (b0 + w.c0 + v < p.batch) word |= C::put(uint8_t(x[v]), v);
    C::store(dst + r * p.bt + w.c0, word);
  }
}

template <bool SROUTES, int V>
__global__ void __launch_bounds__(kThreads<V>) ib_lut_fused_kernel(Params p) {
  using Route = std::conditional_t<SROUTES, SharedRoutes, GlobalRoutes>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int bt = p.bt;
  const int b0 = blockIdx.x * bt;
  int* unsat = reinterpret_cast<int*>(smem);  // [2][bt], by body parity
  uint8_t* A = smem + 2 * sizeof(int) * bt;   // CN view [n_edges][bt]
  uint8_t* B = A + p.n_edges * bt;            // VN view [n_edges][bt]
  uint8_t* CHG = B + p.n_edges * bt;          // channel [n_vars][bt]
  uint8_t* TC = CHG + p.n_vars * bt;           // CN LUTs of this iteration
  uint8_t* TV = TC + p.n_cn_slots * p.slot;    // VN LUTs of this iteration
  uint8_t* MC = TV + p.n_vn_slots * p.slot;    // CN alignment rows
  uint8_t* MV = MC + p.d_c_max * p.t_decoder;  // VN alignment rows
  uint16_t* R = reinterpret_cast<uint16_t*>(smem + route_offset(p));  // routes, if staged

  const int cn_stage = p.n_cn_slots * p.slot;
  const int vn_stage = p.n_vn_slots * p.slot;
  const int mc_stage = p.d_c_max * p.t_decoder;
  const int mv_stage = p.d_v_max * p.t_decoder;
  const ib_lut::Luts cn_lut0{TC, p.slot, p.t_channel};  // iteration-0 tables: [.., Tch]
  const ib_lut::Luts cn_lut{TC, p.slot, p.t_decoder};
  const ib_lut::Luts vn_lut{TV, p.slot, p.t_decoder};
  Route cn_route, vn_route;
  if constexpr (SROUTES) {
    for (int t = threadIdx.x; t < 2 * p.n_edges; t += blockDim.x)
      R[t] = t < p.n_edges ? p.cn_route16[t] : p.vn_route16[t - p.n_edges];
    cn_route = Route{R};
    vn_route = Route{R + p.n_edges};
  } else {
    cn_route = Route{p.cn_route};
    vn_route = Route{p.vn_route};
  }
  // The launch has q * (bt / V) threads: one division per thread and launch.
  const int lanes = bt / V;
  const Walk w{int(threadIdx.x) / lanes, int(blockDim.x) / lanes,
               int(threadIdx.x) % lanes * V};

  seed_rows<V>(p, A, p.seed_var, p.n_edges, b0, w);
  seed_rows<V>(p, CHG, p.node_var, p.n_vars, b0, w);
  stage(TC, p.cn_tab, cn_stage);
  stage(MC, p.match_cn, mc_stage);
  __syncthreads();
  // During each pass the tables of the next one are staged: the pass before
  // it, which read the slots they overwrite, ended at the last barrier.
  stage(TV, p.vn_tab, vn_stage);
  stage(MV, p.match_vn, mv_stage);
  for (int c = threadIdx.x; c < bt; c += blockDim.x) unsat[c] = 0;
  cn_pass<V>(p, A, B, cn_lut0, MC, cn_route, nullptr, w);
  __syncthreads();

  int iters = 0;
  for (int i = 0; i < p.imax - 1; ++i) {
    int* u = unsat + (i & 1) * bt;
    stage(TC, p.cn_tab + size_t(i + 1) * cn_stage, cn_stage);
    stage(MC, p.match_cn + size_t(i + 1) * mc_stage, mc_stage);
    vn_pass<V>(p, B, A, CHG, vn_lut, MV, vn_route, w);
    __syncthreads();
    stage(TV, p.vn_tab + size_t(i + 1) * vn_stage, vn_stage);
    stage(MV, p.match_vn + size_t(i + 1) * mv_stage, mv_stage);
    // The other buffer is the next body's: this body's counts stay for the
    // report.
    for (int c = threadIdx.x; c < bt; c += blockDim.x) unsat[((i + 1) & 1) * bt + c] = 0;
    const bool odd = cn_pass<V>(p, A, B, cn_lut, MC, cn_route, u, w);
    iters = i + 1;
    // The predicate is OR-ed over the block: every thread takes the same branch.
    if (!__syncthreads_or(odd) && p.early_exit) break;
  }

  // TV holds the VN tables of iteration `iters`, staged during the last pass.
  decide_pass<V>(p, B, CHG, vn_lut, b0, w);
  for (int c = threadIdx.x; c < bt; c += blockDim.x) {
    if (b0 + c >= p.batch) continue;
    p.unsat_out[b0 + c] = iters == 0 ? 1 : unsat[((iters - 1) & 1) * bt + c];
    p.iters_out[b0 + c] = iters;
  }
}

template <bool SROUTES, int V>
int launch(const Params& p, cudaStream_t stream) {
  const auto kernel = ib_lut_fused_kernel<SROUTES, V>;
  const size_t smem = shared_bytes(p);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int lanes = p.bt / V;
  if (lanes > kThreads<V>) return int(cudaErrorInvalidValue);
  const int grid = (p.batch + p.bt - 1) / p.bt;
  kernel<<<grid, (kThreads<V> / lanes) * lanes, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <bool SROUTES>
int launch_v(const Params& p, cudaStream_t stream) {
  return p.bt % 4 == 0 ? launch<SROUTES, 4>(p, stream) : launch<SROUTES, 1>(p, stream);
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
                        const uint16_t* cn_route16, const uint16_t* vn_route16,
                        const int32_t* cn_groups, const int32_t* vn_groups,
                        int n_cn_groups, int n_vn_groups, int n_vars, int n_edges,
                        int batch, int bt, int t_channel, int t_decoder,
                        int n_cn_slots, int n_vn_slots, int slot, int d_c_max,
                        int d_v_max, int imax, int early_exit, void* stream) {
  Params p{clusters,    outputs,     unsat_out,  iters_out,  cn_tab,      vn_tab,
           match_cn,    match_vn,    seed_var,   node_var,   cn_route,    vn_route,
           cn_route16,  vn_route16,  cn_groups,  vn_groups,  n_cn_groups, n_vn_groups,
           n_vars,      n_edges,     batch,      bt,         t_channel,   t_decoder,
           n_cn_slots,  n_vn_slots,  slot,       d_c_max,    d_v_max,     imax,
           early_exit};
  if (bt < 1) return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return routes_fit(p) ? launch_v<true>(p, s) : launch_v<false>(p, s);
}

int ib_lut_fused_max_degree() { return kMaxDegree; }
int ib_lut_fused_threads_v4() { return kThreads<4>; }
int ib_lut_fused_threads_v1() { return kThreads<1>; }

const char* ib_lut_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
