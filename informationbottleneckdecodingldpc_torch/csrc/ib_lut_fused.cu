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
// What bounds it on this card (an NVIDIA H100 80GB HBM3 at 700 W). One CTA
// per SM, set by shared memory. Device memory sees only the clusters in and
// the decisions out. The work is chains of dependent byte lookups in shared
// memory: a WLAN |T|=16 body makes 40,986 lookups per codeword (31,698
// pairwise, 9,288 alignment), which at one warp-wide access per clock and SM
// bound a batch-4096, 49-body decode at 0.9965 ms. Two paths, chosen per
// launch from the tables and the carve (lanes_fit; ib_lut_fused.py
// kernel_shared_bytes mirrors it):
//   per-lane, where |T| and |T_ch| are at most 16 (WLAN |T|=16 at its tile
//     of 16: 222,672 B): the views and the channel at 4 bits a message
//     (84,672 B), the alignment rows, and a copy of the passes' pairwise
//     tables per lane (LaneLuts, 131,072 B, K5b's and K3's layout), so that
//     a lookup is one multiply-add and one load from the lane's own bank;
//     the routes are read as uint16 from device memory (L1), and each stage
//     of the tables goes through one of two 3,248-byte buffers;
//   per block, otherwise (WLAN |T|=32 at 16: 206,064 B, of which 169,344 B
//     views and channel, 18,576 B uint16 routes, 18,016 B tables and rows;
//     regular N=8000 at tile 4: 225,968 B, 192,000 B of views and channel,
//     the routes read as int32 from device memory): byte views and one byte
//     copy of each table per block. A per-lane copy of a 1 KB |T|=32 table
//     takes 32 KB, and no two of them fit beside the views.
// On the per-lane path a launch with too few tiles to fill the card runs each
// tile on a thread-block cluster of c CTAs on c SMs (ib_lut_fused.py
// cluster_size: the largest of 4, 3 and 2 whose clusters, one a tile, the
// card holds at once by cudaOccupancyMaxActiveClusters at the carve, so no
// tile waits for a second wave; else one CTA a tile). One CTA an SM leaves a
// tile's passes bound by its slowest thread's chains of lookups, not by the
// SM's lookups: at WLAN's batch 512 (32 tiles on 32 of 132 SMs) K1 ran at
// 12% of its lookup bound. A cluster splits each pass's nodes into contiguous
// spans balanced by lookups (cluster_split); each CTA holds the whole carve
// at the same offsets, reads only its own nodes' rows, and stores each routed
// output with st.shared::cluster into the CTA that owns the row (the rank
// packed above the row in the route); cluster barriers replace the block
// barriers, and the exit test ORs a flag that every warp with an odd count
// sets in every CTA. The tile, its exit and every output stay as at one CTA.
// An H100 SXM holds 30 clusters of 4, 39 of 3 and 66 of 2 at this carve, so
// the 32 tiles of batch 512 take 3. Measured at batch 512, 2.4 dB (CUDA
// events, WLAN's degrees only): one CTA a tile 0.9079 ms, clusters of 3
// 0.5233 ms; 30 tiles on clusters of 4 0.4820 ms; 1024 on clusters of 2
// 0.6870 against 0.9082 ms. The slowest thread's lookups a column fall from
// 169 (CN) and 192 (VN) to 73 and 76 at 3 CTAs, but each CTA still stages
// all the per-lane tables (160 KB of stores a body) and waits at two cluster
// barriers: a copy whose stores all stayed local took 0.50 ms, so the remote
// stores cost about 8%. Storing through the owner's mapped address also where
// the owner is the CTA itself, with no branch, was 1-4% faster than a local
// store on that branch; spreading the stages from the threads of the row
// slots that walk a node fewer gained nothing at 3 CTAs and lost at 2.
// Measured on WLAN |T|=16 at batch 4096, 49 bodies (CUDA events): the
// per-block path took 2.4028 ms. The same kernel with every pairwise lookup
// sent to one per-lane copy (results not kept) took 1.7709 ms: bank
// conflicts were 26% of its time, as random lanes meet in a bank of a
// 256-byte table (64 words over 32 banks) twice as often as not, and the
// chains' latency and issue the rest. The per-lane path takes 1.8253 ms,
// bit for bit the per-block path's result; staging its tables (160 KB of
// shared-memory stores a body and tile) costs it 0.13 ms against the same
// kernel that stages them once. Staged at the start of each pass, as the
// per-block path stages, they cost 0.27 ms: every warp waited on the loads
// and the stores before its first lookup. At tile 8 the per-block path is
// slower (2.6705 ms; per-lane 2.1607), so the tile stays 16.
// The design against each candidate limit of the per-block path:
//   (1) routes: staged once per tile into shared memory as uint16 where they
//       fit beside the views (WLAN |T|=32: 18,576 B), so no route is read
//       from device memory inside an iteration there; on regular N=8000
//       (tile 4: 96,000 B of routes) they do not fit and are read as int32;
//   (2)+(3) division and rounds: a block runs q * (bt / V) threads; a
//       thread keeps V codeword columns c0 .. c0+V-1 for the whole decode
//       and steps q nodes at a time, flat over all degree groups of a pass
//       (its node carries from one group to the next), with no division per
//       item. Splitting WLAN's degree-11 variable nodes into two items (each
//       recomputing its prefix) was measured and lost: the tail it removes
//       costs less than the lookups and loads it adds;
//   (4) bank conflicts: two earlier conflict-free layouts lost, nibble-packed
//       tables at |T| <= 16 (their extraction lengthened every chain step)
//       and a second copy per half-warp at |T|=32; the per-lane copies win
//       where the views at 4 bits make room for them;
//   (5) wider work: V = 4 columns per thread where 4 divides the tile (else
//       1). A message row is one 32-bit (16-bit at 4 bits) load, a routed
//       output one store, a route read once per four columns, and the four
//       columns' folds are unrolled side by side, four independent chains
//       per thread. Threads per CTA are the most at which no instantiation
//       spills (chip_smoke.py phase 2 prints ptxas's lines): 640 at V = 4
//       (96 registers; 768 spill), 1024 at V = 1.
// Two barriers a body; the exit test is the barrier after the CN pass.
// Earlier designs on the same card (cli/kernel_times.py): the first one
// thread per (node, codeword), WLAN |T|=16 at batch 4096, 49 bodies, 3.1476
// ms; the per-block design 2.4400 ms, at 2.4 dB with early exit 1.8386
// ms; WLAN |T|=32 at batch 2048 2.2974 -> 2.0302 ms; regular N=8000 at batch
// 512, tile 4, i_max 250 8.6143 -> 5.6651 ms.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "ib_lut_groups.cuh"

namespace {

constexpr int kMaxDegree = 16;
constexpr size_t kMaxShared = 232448;  // ib_lut_fused.py:MAX_SHARED_BYTES
// The per-lane tables (LaneLuts): 16 byte positions in 4 groups, a group 256
// entries of 32 lanes' words; |T| and |T_ch| at most 16, so an entry
// a * stride + b is below 256 and a message fits 4 bits.
constexpr int kLanePositions = 16;
constexpr int kLaneEntries = 256;
constexpr int kLaneGroupBytes = kLaneEntries * 128;
constexpr size_t kLaneBytes = kLanePositions / 4 * kLaneGroupBytes;  // 131,072
constexpr int kLaneMaxT = 16;
constexpr int kMaxCluster = 4;  // CTAs a tile on the cluster path, at most
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
  // The per-lane tables' stages, [i_max][stage words] each (ib_lut_fused.py
  // lane_words): a stage's groups of words ([groups][kLaneEntries]; a CN
  // stage's from the first group, a VN stage's to the last), then its
  // alignment rows padded to 16 bytes; null where the tables take none.
  const uint32_t* lane_cn;
  const uint32_t* lane_vn;
  // The cluster path's (ib_lut_fused.py cluster_arrays; null at one CTA a
  // tile): the routes with the rank of the CTA that owns the row's node in
  // bits 16 and up, and each rank's first check and first variable in walk
  // order, [2][cluster + 1].
  const uint32_t* cn_route_cl;
  const uint32_t* vn_route_cl;
  const int32_t* split;
  const int32_t* cn_groups;   // [n_cn_groups, 3] (offset, num_nodes, degree)
  const int32_t* vn_groups;   // [n_vn_groups, 4] (offset, num_nodes, degree, node offset)
  int n_cn_groups, n_vn_groups;
  int n_vars, n_edges, batch, bt;
  int t_channel, t_decoder;
  int n_cn_slots, n_vn_slots, slot;
  int d_c_max, d_v_max;
  int imax, early_exit;
  int cluster;  // CTAs a tile: 1, or a cluster of 2 .. kMaxCluster on the per-lane path
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

// Slots of the per-lane tables' VN positions: the VN pass's LUTs 0 .. d_v-2
// (the decision's last one stays per block).
__host__ __device__ inline int lane_vn_slots(const Params& p) { return p.d_v_max - 1; }

// The per-lane path's carve before its tables: unsat counts, views A, B and
// the channel at 4 bits a message, the alignment rows, 16-byte aligned.
__host__ __device__ inline size_t lane_offset(const Params& p) {
  return (2 * sizeof(int) * p.bt + size_t(2 * p.n_edges + p.n_vars) * p.bt / 2
          + size_t(p.d_c_max + p.d_v_max) * p.t_decoder + 15) / 16 * 16;
}

// Groups of a CN and of a VN stage, and the first group of a VN stage.
__host__ __device__ inline int lane_cn_groups(const Params& p) { return (p.n_cn_slots + 3) / 4; }
__host__ __device__ inline int lane_vn_group0(const Params& p) {
  return (kLanePositions - lane_vn_slots(p)) / 4;
}
// Bytes of a stage as lane_cn / lane_vn hold it: its groups' words, then its
// alignment rows padded to 16 bytes.
__host__ __device__ inline int lane_stage_bytes(int groups, int row_bytes) {
  return groups * kLaneEntries * 4 + (row_bytes + 15) / 16 * 16;
}
__host__ __device__ inline int lane_cn_stage(const Params& p) {
  return lane_stage_bytes(lane_cn_groups(p), p.d_c_max * p.t_decoder);
}
__host__ __device__ inline int lane_vn_stage(const Params& p) {
  return lane_stage_bytes(kLanePositions / 4 - lane_vn_group0(p), p.d_v_max * p.t_decoder);
}
// The two buffers of stages in flight, after the per-lane tables.
__host__ __device__ inline size_t lane_buffer_bytes(const Params& p) {
  const int cn = lane_cn_stage(p), vn = lane_vn_stage(p);
  return size_t(cn > vn ? cn : vn);
}
__host__ __device__ inline size_t lane_carve(const Params& p) {
  return lane_offset(p) + kLaneBytes + 2 * lane_buffer_bytes(p);
}

// Whether the tile runs on per-lane tables: the words exist (|T|, |T_ch| <= 16,
// the CN and VN slots within 16 positions), 4 columns a thread, and the carve
// fits.
__host__ __device__ inline bool lanes_fit(const Params& p) {
  return p.lane_cn != nullptr && p.cn_route16 != nullptr && p.t_decoder <= kLaneMaxT
         && p.t_channel <= kLaneMaxT && p.bt % 4 == 0
         && p.n_cn_slots + lane_vn_slots(p) <= kLanePositions
         && size_t(p.n_vn_slots) * p.slot <= kLaneBytes && lane_carve(p) <= kMaxShared;
}

// K1's carve; ib_lut_fused.py:kernel_shared_bytes mirrors it.
__host__ __device__ inline size_t shared_bytes(const Params& p) {
  if (lanes_fit(p)) return lane_carve(p);
  return routes_fit(p) ? route_offset(p) + 4 * size_t(p.n_edges) : carve_bytes(p);
}

// Distributed shared memory of a thread-block cluster (PTX ISA, sm_90).
namespace cluster {
__device__ __forceinline__ uint32_t rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Every thread of the cluster arrives and waits: the stores of each before
// it, to any CTA's shared memory, are seen by all after it.
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}
// The address of `p` (this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ uint32_t map(const void* p, uint32_t rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return r;
}
__device__ __forceinline__ void store(uint32_t a, uint16_t v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;" ::"r"(a), "h"(v));
}
__device__ __forceinline__ void store(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v));
}
__device__ __forceinline__ uint32_t load(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
}  // namespace cluster

// Routes in shared memory (uint16) or device memory (int32, or uint16 on the
// per-lane path).
struct SharedRoutes {
  const uint16_t* r;
  __device__ __forceinline__ int operator[](int i) const { return r[i]; }
};
struct GlobalRoutes {
  const int32_t* r;
  __device__ __forceinline__ int operator[](int i) const { return __ldg(&r[i]); }
};
struct GlobalRoutes16 {
  const uint16_t* r;
  __device__ __forceinline__ int operator[](int i) const { return __ldg(&r[i]); }
};
// The cluster path's (uint32 from device memory): the row in the low 16 bits,
// the rank of the CTA that owns it above.
struct ClusterRoutes {
  const uint32_t* r;
};

// Pairwise LUTs of one pass with a copy per lane, the layout of K5b's
// lookup2d_lanes (peaks.cu) and K3's LaneLuts (ib_lut_hbm.cu): lane l's copy
// of entry x at byte position q is byte q % 4 of word
// ((q / 4) * kLaneEntries + x) * 32 + l, so each lane reads only its own bank.
// The CN pass's slot s sits at position s, the VN pass's at 15 - s: the two
// passes share no byte, and a slot's offset is a constant. A lookup is one
// multiply-add, a * 128 stride on the lane's row of b, and one load.
template <bool VN>
struct LaneLuts {
  const uint8_t* base;
  uint32_t lane;  // 4 * lane
  int stride128;  // 128 x the tables' row stride
  __device__ __forceinline__ uint8_t operator()(int l, int a, int b) const {
    const int q = VN ? kLanePositions - 1 - l : l;
    return base[a * stride128 + ib_lut::lane_row(lane, b) + (q >> 2) * kLaneGroupBytes
                + (q & 3)];
  }
};

// V columns of a view row at BITS bits a message: one byte (V = 1), one
// 32-bit word (V = 4, bytes) or one 16-bit half (V = 4, 4 bits).
template <int V, int BITS>
struct Cols {
  static_assert((V == 1 && BITS == 8) || (V == 4 && (BITS == 8 || BITS == 4)),
                "1 or 4 columns per thread; 4 at 4 bits");
  using W = std::conditional_t<V * BITS == 32, uint32_t,
                               std::conditional_t<V * BITS == 16, uint16_t, uint8_t>>;
  // Bytes of `cols` columns: a row's length, a thread's first column's offset.
  static __host__ __device__ __forceinline__ int bytes(int cols) { return cols * BITS / 8; }
  static __device__ __forceinline__ W load(const uint8_t* p) {
    return *reinterpret_cast<const W*>(p);
  }
  static __device__ __forceinline__ void store(uint8_t* p, W w) {
    *reinterpret_cast<W*>(p) = w;
  }
  static __device__ __forceinline__ uint8_t get(W w, int v) {
    return uint8_t((w >> (BITS * v)) & ((1u << BITS) - 1));
  }
  static __device__ __forceinline__ W put(uint8_t x, int v) { return W(W(x) << (BITS * v)); }
};

// A thread's place in every pass: columns c0 .. c0+V-1 and first item
// `item0`; it steps `q` items at a time. `rb` is a view row's bytes, `cb`
// the byte offset of column c0 in it.
struct Walk {
  int item0, q, c0, rb, cb;
};

// The nodes of a pass that a CTA walks, flat indices lo .. hi - 1 (on the
// cluster path; one CTA a tile walks every node).
struct Span {
  int lo, hi;
};

// Stores routed output i (V columns `x`) into view `dst`: row route[i], at the
// thread's columns. On the cluster path into the view of the CTA that owns
// the row, at the same offset (its own too: no branch); a thread's columns
// are whole bytes of the row, so no other thread's store shares them.
template <class C, class Route>
__device__ __forceinline__ void put(Route route, uint8_t* dst, int i, Walk w, typename C::W x) {
  if constexpr (std::is_same_v<Route, ClusterRoutes>) {
    const uint32_t e = __ldg(&route.r[i]);
    uint8_t* at = dst + int(e & 0xffffu) * w.rb + w.cb;
    cluster::store(cluster::map(at, e >> 16), x);
  } else {
    C::store(dst + route[i] * w.rb + w.cb, x);
  }
}

// One check node of degree D at local index `ln` of its group, columns c0..:
// leave-one-out, aligned, routed into dst; cnt[v] counts its odd parity.
// The V columns' folds are unrolled side by side: V independent lookup
// chains in flight per thread.
template <int D, int V, int BITS, class Route, class Lut>
__device__ __forceinline__ void cn_item(const uint8_t* __restrict__ src,
                                        uint8_t* __restrict__ dst, Lut lut,
                                        const uint8_t* __restrict__ match_row, Route route,
                                        int off, int n, int ln, Walk w, int thresh,
                                        int (&cnt)[V]) {
  using C = Cols<V, BITS>;
  typename C::W x[D], o[D];
  const uint8_t* in = src + (off + ln) * w.rb + w.cb;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    x[k] = C::load(in + k * n * w.rb);
    o[k] = 0;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    uint8_t m[D], out[D];
    int parity = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      m[k] = C::get(x[k], v);
      parity ^= int(m[k] < thresh);
    }
    cnt[v] += parity;
    ib_lut::cn_fold<D>(m, out, lut);
#pragma unroll
    for (int k = 0; k < D; ++k) o[k] |= C::put(match_row[out[k]], v);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) put<C>(route, dst, off + k * n + ln, w, o[k]);
}

// One variable node of degree D (channel row `chg_row`), columns c0..:
// leave-one-out, aligned, routed into dst; degree 1 forwards the channel,
// unaligned.
template <int D, int V, int BITS, class Route, class Lut>
__device__ __forceinline__ void vn_item(const uint8_t* __restrict__ src,
                                        uint8_t* __restrict__ dst,
                                        const uint8_t* __restrict__ chg_row, Lut lut,
                                        const uint8_t* __restrict__ match_row, Route route,
                                        int off, int n, int ln, Walk w) {
  using C = Cols<V, BITS>;
  const typename C::W chw = C::load(chg_row + w.cb);
  if constexpr (D == 1) {
    put<C>(route, dst, off + ln, w, chw);
  } else {
    typename C::W x[D], o[D];
    const uint8_t* in = src + (off + ln) * w.rb + w.cb;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      x[k] = C::load(in + k * n * w.rb);
      o[k] = 0;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint8_t m[D], out[D];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = C::get(x[k], v);
      ib_lut::vn_fold<D>(C::get(chw, v), m, out, lut);
#pragma unroll
      for (int k = 0; k < D; ++k) o[k] |= C::put(match_row[out[k]], v);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) put<C>(route, dst, off + k * n + ln, w, o[k]);
  }
}

// CN pass A -> B over every check group, flat: a thread's node carries from
// one group to the next (on the cluster path, over the CTA's span `s`). With
// `unsat`, adds this thread's odd-parity counts per column and returns
// whether it had any.
template <bool CLUSTER, int V, int BITS, class Route, class Lut>
__device__ bool cn_pass(const Params& p, const uint8_t* A, uint8_t* B, Lut lut,
                        const uint8_t* match, Route route, int* unsat, Walk w, Span s) {
  int cnt[V] = {};
  int node = (CLUSTER ? s.lo : 0) + w.item0, first = 0;  // `first`: the group's first node
  for (int k = 0; k < p.n_cn_groups; ++k) {
    const int off = p.cn_groups[3 * k], n = p.cn_groups[3 * k + 1];
    const int d = p.cn_groups[3 * k + 2], end = first + n;
    const int stop = CLUSTER ? min(end, s.hi) : end;
    const uint8_t* row = match + (d - 1) * p.t_decoder;
    switch (d) {
#define K1_CN_CASE(D)                                                                   \
  case D:                                                                               \
    for (; node < stop; node += w.q)                                                    \
      cn_item<D, V, BITS>(A, B, lut, row, route, off, n, node - first, w,               \
                          p.t_decoder / 2, cnt);                                        \
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

// VN pass B -> A over every variable group, flat (on the cluster path, over
// the span `s`), with the channel clusters `chg` ([n_vars][row], group order).
template <bool CLUSTER, int V, int BITS, class Route, class Lut>
__device__ void vn_pass(const Params& p, const uint8_t* B, uint8_t* A, const uint8_t* chg,
                        Lut lut, const uint8_t* match, Route route, Walk w, Span s) {
  int node = (CLUSTER ? s.lo : 0) + w.item0;
  for (int k = 0; k < p.n_vn_groups; ++k) {
    const int off = p.vn_groups[4 * k], n = p.vn_groups[4 * k + 1];
    const int d = p.vn_groups[4 * k + 2], first = p.vn_groups[4 * k + 3], end = first + n;
    const int stop = CLUSTER ? min(end, s.hi) : end;
    const uint8_t* row = match + (d - 1) * p.t_decoder;
    switch (d) {
#define K1_VN_CASE(D)                                                                   \
  case D:                                                                               \
    for (; node < stop; node += w.q)                                                    \
      vn_item<D, V, BITS>(B, A, chg + node * w.rb, lut, row, route, off, n, node - first, \
                          w);                                                           \
    break;
      K1_VN_CASE(1)
      IB_DEGREES_2_TO_16(K1_VN_CASE)
#undef K1_VN_CASE
      default:
        __trap();
    }
  }
}

// Decision fold of every variable node (channel plus all messages; on the
// cluster path those of the span `s`), written to outputs[var][batch] at the
// thread's real columns.
template <bool CLUSTER, int V, int BITS>
__device__ void decide_pass(const Params& p, const uint8_t* B, const uint8_t* chg,
                            ib_lut::Luts lut, int b0, Walk w, Span s) {
  using C = Cols<V, BITS>;
  int node = (CLUSTER ? s.lo : 0) + w.item0;
  for (int k = 0; k < p.n_vn_groups; ++k) {
    const int off = p.vn_groups[4 * k], n = p.vn_groups[4 * k + 1];
    const int d = p.vn_groups[4 * k + 2], first = p.vn_groups[4 * k + 3], end = first + n;
    const int stop = CLUSTER ? min(end, s.hi) : end;
    for (; node < stop; node += w.q) {
      const uint8_t* in = B + (off + node - first) * w.rb + w.cb;
      const typename C::W chw = C::load(chg + node * w.rb + w.cb);
      int32_t* out = p.outputs + size_t(__ldg(&p.node_var[node])) * p.batch + b0 + w.c0;
      for (int v = 0; v < V && b0 + w.c0 + v < p.batch; ++v) {
        uint8_t s = lut(0, C::get(chw, v), C::get(C::load(in), v));
        for (int j = 1; j < d; ++j) s = lut(j, s, C::get(C::load(in + j * n * w.rb), v));
        out[v] = s;
      }
    }
  }
}

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = __ldg(&src[t]);
}

// A stage of the per-lane tables moves in two steps, so that neither the
// latency of device memory nor the stores sit at a pass's start, where every
// warp of the block would wait on them: `copy_stage` starts an asynchronous
// copy of the stage as lane_cn / lane_vn hold it into a buffer of shared
// memory (cp.async, 16 bytes a thread, no registers held) at the start of the
// pass two before the one that reads it; `spread_stage` writes the buffer's
// words to the 32 lanes' copies, a word for four lanes with one 16-byte
// store (a warp the copies of four entries), and its alignment rows, at the
// end of the pass before, while the block's last warps still look up. A
// group that the other pass also reads holds its bytes unchanged in the
// words.
__device__ __forceinline__ void copy_stage(uint8_t* buf, const uint32_t* __restrict__ src,
                                           int bytes) {
  for (int c = threadIdx.x; c < bytes / 16; c += blockDim.x) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(buf + 16 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src + 4 * c));
  }
}

// Waits for this thread's copies; the barrier after it shows them to the block.
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ __forceinline__ void spread_stage(uint8_t* L, const uint8_t* buf, int g0, int groups,
                                             uint8_t* rows, int row_bytes) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(buf);
  uint4* dst = reinterpret_cast<uint4*>(L + g0 * kLaneGroupBytes);
  for (int i = threadIdx.x; i < 8 * kLaneEntries * groups; i += blockDim.x) {
    const uint32_t v = words[i >> 3];
    dst[i] = make_uint4(v, v, v, v);
  }
  const uint8_t* src_rows = buf + groups * kLaneEntries * 4;
  for (int t = threadIdx.x; t < row_bytes; t += blockDim.x) rows[t] = src_rows[t];
}

// A seed row: row r of `dst` at the thread's columns <- the channel cluster
// of variable var[r] (padding columns 0).
template <int V, int BITS>
__device__ __forceinline__ void seed_row(const Params& p, uint8_t* dst,
                                         const int32_t* __restrict__ var, int r, int b0, Walk w) {
  using C = Cols<V, BITS>;
  const int32_t* x = p.clusters + size_t(__ldg(&var[r])) * p.batch + b0 + w.c0;
  typename C::W word = 0;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (b0 + w.c0 + v < p.batch) word |= C::put(uint8_t(x[v]), v);
  C::store(dst + r * w.rb + w.cb, word);
}

// The seed rows lo .. hi - 1 of `dst`.
template <int V, int BITS>
__device__ void seed_rows(const Params& p, uint8_t* dst, const int32_t* __restrict__ var,
                          int lo, int hi, int b0, Walk w) {
  for (int r = lo + w.item0; r < hi; r += w.q) seed_row<V, BITS>(p, dst, var, r, b0, w);
}

// The CN view's seed rows of the checks of span `s` (the cluster path).
template <int V, int BITS>
__device__ void seed_checks(const Params& p, uint8_t* A, int b0, Walk w, Span s) {
  int node = s.lo + w.item0, first = 0;
  for (int k = 0; k < p.n_cn_groups; ++k) {
    const int off = p.cn_groups[3 * k], n = p.cn_groups[3 * k + 1];
    const int d = p.cn_groups[3 * k + 2], end = first + n, stop = min(end, s.hi);
    for (; node < stop; node += w.q)
      for (int j = 0; j < d; ++j)
        seed_row<V, BITS>(p, A, p.seed_var, off + j * n + node - first, b0, w);
    first = end;
  }
}

// LANES: views at 4 bits a message, the pairwise LUTs of the passes per lane
// (staged from lane_cn / lane_vn), routes read as uint16 from device memory.
// CLUSTER (the per-lane path): a tile runs on a cluster of Params::cluster
// CTAs on as many SMs: each CTA holds the whole carve at the same offsets,
// walks its span of the checks and of the variables (Params::split), reads
// only the view rows of its own nodes, and stores each routed output into
// the view of the CTA that owns the row (ClusterRoutes); cluster barriers
// take the place of the block barriers between passes, and the exit test
// ORs over the cluster.
template <bool SROUTES, int V, bool LANES, bool CLUSTER>
__global__ void __launch_bounds__(kThreads<V>) ib_lut_fused_kernel(Params p) {
  static_assert(!LANES || (V == 4 && !SROUTES), "the per-lane path: 4 columns, device routes");
  static_assert(!CLUSTER || LANES, "clusters on the per-lane path");
  constexpr int BITS = LANES ? 4 : 8;
  using C = Cols<V, BITS>;
  using Route = std::conditional_t<
      CLUSTER, ClusterRoutes,
      std::conditional_t<LANES, GlobalRoutes16,
                         std::conditional_t<SROUTES, SharedRoutes, GlobalRoutes>>>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int bt = p.bt;
  const int b0 = (CLUSTER ? int(blockIdx.x) / p.cluster : int(blockIdx.x)) * bt;
  const int rb = C::bytes(bt);
  int* unsat = reinterpret_cast<int*>(smem);  // [2][bt], by body parity
  uint8_t* A = smem + 2 * sizeof(int) * bt;   // CN view [n_edges][rb]
  uint8_t* B = A + p.n_edges * rb;            // VN view [n_edges][rb]
  uint8_t* CHG = B + p.n_edges * rb;          // channel [n_vars][rb]
  // Per-block path: this iteration's CN and VN LUTs, then the alignment rows.
  // Per-lane path: the alignment rows, then the per-lane LUTs (L); the
  // decision's VN LUTs (TV) reuse L after the last body.
  uint8_t* TC = CHG + p.n_vars * rb;
  uint8_t* TV = TC + p.n_cn_slots * p.slot;
  uint8_t* MC = LANES ? TC : TV + p.n_vn_slots * p.slot;
  uint8_t* MV = MC + p.d_c_max * p.t_decoder;
  uint8_t* L = smem + lane_offset(p);
  if constexpr (LANES) TV = L;
  uint16_t* R = reinterpret_cast<uint16_t*>(smem + route_offset(p));  // routes, if staged

  // The cluster path: this CTA's rank, its spans, and the exit flags, one a
  // body parity, that every CTA of the cluster sets in every other.
  uint32_t me = 0;
  Span cn_span{0, 0}, vn_span{0, 0};
  int* flags = nullptr;
  if constexpr (CLUSTER) {
    __shared__ int exit_flags[2];
    flags = exit_flags;
    me = cluster::rank();
    const int* vn_split = p.split + p.cluster + 1;
    cn_span = {__ldg(&p.split[me]), __ldg(&p.split[me + 1])};
    vn_span = {__ldg(&vn_split[me]), __ldg(&vn_split[me + 1])};
    if (threadIdx.x == 0) flags[0] = 0;
  }
  // A block barrier, or a cluster barrier where passes store into other CTAs.
  const auto sync = [] {
    if constexpr (CLUSTER)
      cluster::sync();
    else
      __syncthreads();
  };

  const int cn_stage = p.n_cn_slots * p.slot;
  const int vn_stage = p.n_vn_slots * p.slot;
  const int mc_stage = p.d_c_max * p.t_decoder;
  const int mv_stage = p.d_v_max * p.t_decoder;
  const uint32_t lane4 = 4u * (threadIdx.x & 31);
  // iteration-0 CN tables: [.., Tch]
  const auto cn_lut0 = [&] {
    if constexpr (LANES) return LaneLuts<false>{L, lane4, 128 * p.t_channel};
    else return ib_lut::Luts{TC, p.slot, p.t_channel};
  }();
  const auto cn_lut = [&] {
    if constexpr (LANES) return LaneLuts<false>{L, lane4, 128 * p.t_decoder};
    else return ib_lut::Luts{TC, p.slot, p.t_decoder};
  }();
  const auto vn_lut = [&] {
    if constexpr (LANES) return LaneLuts<true>{L, lane4, 128 * p.t_decoder};
    else return ib_lut::Luts{TV, p.slot, p.t_decoder};
  }();
  // The passes in order: P = 0 the iteration-0 CN pass, then body i's VN
  // pass 2i + 1 and CN pass 2i + 2; the last is 2 imax - 2. Pass P reads the
  // tables of its stage P, which is CN(P / 2) for even P, VN((P - 1) / 2)
  // for odd; every stage but the first is staged during the pass before.
  const int last = 2 * p.imax - 2;
  const int cn_groups = lane_cn_groups(p), vn_group0 = lane_vn_group0(p);
  const int cn_bytes = lane_cn_stage(p), vn_bytes = lane_vn_stage(p);
  uint8_t* buf[2] = {L + kLaneBytes, L + kLaneBytes + lane_buffer_bytes(p)};
  const auto copy = [&](int P) {  // stage P into buffer P % 2
    if (P & 1)
      copy_stage(buf[1], p.lane_vn + size_t(P / 2) * (vn_bytes / 4), vn_bytes);
    else
      copy_stage(buf[0], p.lane_cn + size_t(P / 2) * (cn_bytes / 4), cn_bytes);
  };
  const auto spread = [&](int P) {  // stage P from buffer P % 2
    if (P & 1)
      spread_stage(L, buf[1], vn_group0, kLanePositions / 4 - vn_group0, MV, mv_stage);
    else
      spread_stage(L, buf[0], 0, cn_groups, MC, mc_stage);
  };
  // Work of pass P's start and end besides its nodes. Per block: the next
  // stage at the start, the pass before it having read the slots it
  // overwrites (and the decision's VN tables after the last, where no pass
  // follows). Per lane: the copy of stage P + 2 (into the buffer stage P
  // left) at the start, the spread of stage P + 1 at the end.
  const auto begin = [&](int P) {
    if constexpr (LANES) {
      if (P + 2 <= last) copy(P + 2);
    } else if (P & 1) {
      stage(TC, p.cn_tab + size_t(P / 2 + 1) * cn_stage, cn_stage);
      stage(MC, p.match_cn + size_t(P / 2 + 1) * mc_stage, mc_stage);
    } else {
      stage(TV, p.vn_tab + size_t(P / 2) * vn_stage, vn_stage);
      stage(MV, p.match_vn + size_t(P / 2) * mv_stage, mv_stage);
    }
  };
  const auto end = [&](int P) {
    if constexpr (LANES) {
      if (P + 1 <= last) spread(P + 1);
      copy_wait();
    }
  };
  Route cn_route, vn_route;
  if constexpr (CLUSTER) {
    cn_route = Route{p.cn_route_cl};
    vn_route = Route{p.vn_route_cl};
  } else if constexpr (LANES) {
    cn_route = Route{p.cn_route16};
    vn_route = Route{p.vn_route16};
  } else if constexpr (SROUTES) {
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
  const int c0 = int(threadIdx.x) % lanes * V;
  const Walk w{int(threadIdx.x) / lanes, int(blockDim.x) / lanes, c0, rb, C::bytes(c0)};

  if constexpr (LANES) {
    copy(0);
    if (last >= 1) copy(1);
  }
  if constexpr (CLUSTER) {  // the rows of this CTA's own nodes
    seed_checks<V, BITS>(p, A, b0, w, cn_span);
    seed_rows<V, BITS>(p, CHG, p.node_var, vn_span.lo, vn_span.hi, b0, w);
  } else {
    seed_rows<V, BITS>(p, A, p.seed_var, 0, p.n_edges, b0, w);
    seed_rows<V, BITS>(p, CHG, p.node_var, 0, p.n_vars, b0, w);
  }
  if constexpr (LANES) {
    copy_wait();
    __syncthreads();
    spread(0);
  } else {
    stage(TC, p.cn_tab, cn_stage);
    stage(MC, p.match_cn, mc_stage);
  }
  sync();  // on the cluster path also: every CTA has started before any store into it
  begin(0);
  for (int c = threadIdx.x; c < bt; c += blockDim.x) unsat[c] = 0;
  cn_pass<CLUSTER, V, BITS>(p, A, B, cn_lut0, MC, cn_route, nullptr, w, cn_span);
  end(0);
  sync();

  int iters = 0;
  for (int i = 0; i < p.imax - 1; ++i) {
    int* u = unsat + (i & 1) * bt;
    begin(2 * i + 1);
    vn_pass<CLUSTER, V, BITS>(p, B, A, CHG, vn_lut, MV, vn_route, w, vn_span);
    end(2 * i + 1);
    sync();
    begin(2 * i + 2);
    // The other buffer is the next body's: this body's counts stay for the
    // report.
    for (int c = threadIdx.x; c < bt; c += blockDim.x) unsat[((i + 1) & 1) * bt + c] = 0;
    if constexpr (CLUSTER)
      if (threadIdx.x == 0) flags[(i + 1) & 1] = 0;
    const bool odd = cn_pass<CLUSTER, V, BITS>(p, A, B, cn_lut, MC, cn_route, u, w, cn_span);
    end(2 * i + 2);
    iters = i + 1;
    if constexpr (CLUSTER) {
      // The OR over the cluster: a warp with an odd count sets this body's
      // flag in every CTA; after the barrier every CTA reads the same word,
      // so every thread of the cluster takes the same branch.
      if (__any_sync(~0u, odd) && (threadIdx.x & 31) == 0)
        for (int r = 0; r < p.cluster; ++r) cluster::store(cluster::map(&flags[i & 1], r), 1u);
      sync();
      if (!*reinterpret_cast<volatile int*>(&flags[i & 1]) && p.early_exit) break;
    } else {
      // The predicate is OR-ed over the block: every thread takes the same branch.
      if (!__syncthreads_or(odd) && p.early_exit) break;
    }
  }

  // Per-block path: TV holds the VN tables of iteration `iters`, staged
  // during the last pass. Per-lane path: they are staged now, over the
  // per-lane tables that no pass reads any more.
  if constexpr (LANES) {
    stage(TV, p.vn_tab + size_t(iters) * vn_stage, vn_stage);
    __syncthreads();
  }
  decide_pass<CLUSTER, V, BITS>(p, B, CHG, ib_lut::Luts{TV, p.slot, p.t_decoder}, b0, w, vn_span);
  if constexpr (CLUSTER) {
    // Rank 0 reports the counts, summed over the cluster's CTAs (exact in
    // any order); no CTA leaves while another may still read its memory.
    if (me == 0)
      for (int c = threadIdx.x; c < bt; c += blockDim.x) {
        if (b0 + c >= p.batch) continue;
        int sum = 1;
        if (iters) {
          const int* own = unsat + ((iters - 1) & 1) * bt + c;
          sum = *own;
          for (int r = 1; r < p.cluster; ++r) sum += int(cluster::load(cluster::map(own, r)));
        }
        p.unsat_out[b0 + c] = sum;
        p.iters_out[b0 + c] = iters;
      }
    sync();
  } else {
    for (int c = threadIdx.x; c < bt; c += blockDim.x) {
      if (b0 + c >= p.batch) continue;
      p.unsat_out[b0 + c] = iters == 0 ? 1 : unsat[((iters - 1) & 1) * bt + c];
      p.iters_out[b0 + c] = iters;
    }
  }
}

template <bool SROUTES, int V, bool LANES>
int launch(const Params& p, cudaStream_t stream) {
  const auto kernel = ib_lut_fused_kernel<SROUTES, V, LANES, false>;
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
  return p.bt % 4 == 0 ? launch<SROUTES, 4, false>(p, stream)
                       : launch<SROUTES, 1, false>(p, stream);
}

// The per-lane path's launch on clusters of p.cluster CTAs, a cluster a tile
// (cudaLaunchKernelEx with the cluster's dimension), or, given `active`, the
// query of how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters).
int launch_cluster(const Params& p, cudaStream_t stream, int* active) {
  if (p.cluster < 2 || p.cluster > kMaxCluster || !lanes_fit(p)) return int(cudaErrorInvalidValue);
  const auto kernel = ib_lut_fused_kernel<false, 4, true, true>;
  const size_t smem = shared_bytes(p);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int lanes = p.bt / 4;
  if (lanes > kThreads<4>) return int(cudaErrorInvalidValue);
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = unsigned(p.cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config{};
  const int tiles = active ? 1 : (p.batch + p.bt - 1) / p.bt;
  config.gridDim = dim3(unsigned(tiles * p.cluster));
  config.blockDim = dim3(unsigned(kThreads<4> / lanes * lanes));
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  if (active) return int(cudaOccupancyMaxActiveClusters(active, kernel, &config));
  return int(cudaLaunchKernelEx(&config, kernel, p));
}

}  // namespace

extern "C" {

// Decodes `batch` codewords in tiles of `bt`, one CTA per tile, or on the
// per-lane path a cluster of `cluster` CTAs per tile, on `stream`. Returns
// the cudaError_t of the attribute call or of the launch.
int ib_lut_fused_decode(const int32_t* clusters, int32_t* outputs, int32_t* unsat_out,
                        int32_t* iters_out, const uint8_t* cn_tab, const uint8_t* vn_tab,
                        const uint8_t* match_cn, const uint8_t* match_vn,
                        const int32_t* seed_var, const int32_t* node_var,
                        const int32_t* cn_route, const int32_t* vn_route,
                        const uint16_t* cn_route16, const uint16_t* vn_route16,
                        const uint32_t* lane_cn, const uint32_t* lane_vn,
                        const uint32_t* cn_route_cl, const uint32_t* vn_route_cl,
                        const int32_t* split, const int32_t* cn_groups,
                        const int32_t* vn_groups, int n_cn_groups, int n_vn_groups, int n_vars,
                        int n_edges, int batch, int bt, int t_channel, int t_decoder,
                        int n_cn_slots, int n_vn_slots, int slot, int d_c_max, int d_v_max,
                        int imax, int early_exit, int cluster, void* stream) {
  Params p{clusters,    outputs,     unsat_out,   iters_out,   cn_tab,      vn_tab,
           match_cn,    match_vn,    seed_var,    node_var,    cn_route,    vn_route,
           cn_route16,  vn_route16,  lane_cn,     lane_vn,     cn_route_cl, vn_route_cl,
           split,       cn_groups,   vn_groups,   n_cn_groups, n_vn_groups, n_vars,
           n_edges,     batch,       bt,          t_channel,   t_decoder,   n_cn_slots,
           n_vn_slots,  slot,        d_c_max,     d_v_max,     imax,        early_exit,
           cluster};
  if (bt < 1) return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (cluster != 1) {
    if (cn_route_cl == nullptr || split == nullptr) return int(cudaErrorInvalidValue);
    return launch_cluster(p, s, nullptr);
  }
  if (lanes_fit(p)) return launch<false, 4, true>(p, s);
  return routes_fit(p) ? launch_v<true>(p, s) : launch_v<false>(p, s);
}

// Writes to `active` the clusters of `cluster` CTAs that the card holds at
// once on the per-lane path at K1's carve for this layout and tile (the
// arguments as the decode's). Returns the cudaError_t of the query.
int ib_lut_fused_max_clusters(const uint32_t* lane_cn, const uint16_t* cn_route16, int n_vars,
                              int n_edges, int bt, int t_channel, int t_decoder, int n_cn_slots,
                              int n_vn_slots, int slot, int d_c_max, int d_v_max, int cluster,
                              int* active) {
  Params p{};
  p.lane_cn = lane_cn;
  p.cn_route16 = cn_route16;
  p.n_vars = n_vars;
  p.n_edges = n_edges;
  p.bt = bt;
  p.t_channel = t_channel;
  p.t_decoder = t_decoder;
  p.n_cn_slots = n_cn_slots;
  p.n_vn_slots = n_vn_slots;
  p.slot = slot;
  p.d_c_max = d_c_max;
  p.d_v_max = d_v_max;
  p.cluster = cluster;
  if (bt < 1) return int(cudaErrorInvalidValue);
  return launch_cluster(p, nullptr, active);
}

int ib_lut_fused_max_degree() { return kMaxDegree; }
int ib_lut_fused_threads_v4() { return kThreads<4>; }
int ib_lut_fused_threads_v1() { return kThreads<1>; }
int ib_lut_fused_lane_bytes() { return int(kLaneBytes); }
int ib_lut_fused_max_cluster() { return kMaxCluster; }

const char* ib_lut_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
