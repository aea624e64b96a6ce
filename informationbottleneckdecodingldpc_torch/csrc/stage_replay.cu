// P6: the port's K3 pass program replayed on Hopper (sm_90a), with the
// lookup-table folds replaced by a one-operation fold, to split K3's body
// time into its memory pattern and its folds.
//
// Replaces the Pallas TPU probe of the JAX reference's
// scripts/stage_replay.py:build, which replays the TPU K3's exact stage
// program (chunk strides, channel staging, buffer halves) with fold and
// scatter removed. The port's K3 (ib_lut_hbm.cu) has no DMA chassis, so this
// replays the port's K3 instead and keeps everything it does to memory: the
// ib_lut::Graph arrays, uint8 views [tile][row][bt] in device memory, one
// grid-stride launch per pass over all tiles (hbm_tiles::pass_grid, grid y =
// tile), and per body a VN pass B -> A that also reads the channel plane and
// a CN pass A -> B, with ib_lut_groups.cuh's per-group row reads
// src[(off + k n + node) bt + c] and routed row writes
// dst[route[off + k n + node] bt + c]. Output message k of a node is the XOR
// of its other inputs (the channel included) XOR k, in place of the LUT fold;
// a degree-1 variable node forwards its channel value. K3's table staging and
// exit passes are left out with the folds. Modes (kernels/stage_replay.py
// lists the variants, which also select groups and the channel read):
//
//   write     the passes as K3 runs them
//   nowrite   the reads only, summed per tile into a wrapping checksum so
//             they are not dead
//   staged    the read side through bulk copies: a unit is `piece` nodes of a
//             group, whose plane k is `piece` contiguous 128-byte rows of the
//             tile's slab (and the channel rows likewise); one block per SM
//             double-buffers units through two stages in shared memory (9
//             planes x 24 rows x 128 B = 27 KB each on DVB-S2), consumes them
//             and writes routed as above
//
// What bounds it: device-memory bandwidth. A DVB-S2 body at batch 1024 reads
// and writes both views once and reads the channel plane, 4 x 226,799 +
// 64,800 bytes per codeword, 995 MB, 0.297 ms at the data sheet's 3.35 TB/s.
// Every access is a byte per thread, so a warp moves 32-byte sectors; the
// staged reads are 3 KB bulk copies.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bulk.cuh"
#include "hbm_tiles.cuh"
#include "ib_lut_groups.cuh"

namespace {

using hbm_tiles::first_item;
using hbm_tiles::item_step;
using hbm_tiles::kThreads;

constexpr int kBatchTile = 128;
constexpr int kStagedThreads = 512;

enum Mode { kWrite = 0, kNoWrite = 1, kStaged = 2 };

struct Params {
  ib_lut::Graph g;     // the variant's groups, K3's routes and tile width
  uint8_t* A;          // [n_tiles, n_edges, bt] CN view
  uint8_t* B;          // [n_tiles, n_edges, bt] VN view
  const uint8_t* chg;  // [n_tiles, n_vars, bt] channel plane, group order
  uint32_t* sums;      // [n_tiles] checksums of the reads (nowrite)
  int n_vars, n_edges, chv;
  int piece, stage_planes;  // staged: nodes per unit, planes per stage
};

__device__ __forceinline__ size_t view_base(const Params& p, int tile) {
  return size_t(tile) * p.n_edges * p.g.bt;
}

// A CN group's items as K3's cn_group walks them; returns the sum of the
// bytes read (dead when the outputs are written).
template <int D, bool kOut>
__device__ uint32_t cn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                             const int32_t* __restrict__ route, int off, int n, int bt,
                             int first, int step) {
  uint32_t sum = 0;
  for (int t = first; t < n * bt; t += step) {
    const int node = t / bt;
    const int c = t - node * bt;
    uint8_t m[D], x = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      m[k] = src[(off + k * n + node) * bt + c];
      x ^= m[k];
      sum += m[k];
    }
    if (kOut) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        dst[__ldg(&route[off + k * n + node]) * bt + c] = uint8_t(x ^ m[k] ^ k);
    }
  }
  return sum;
}

// A VN group's items as K3's vn_group walks them; `chg` null: the channel
// is not read and counts as 0.
template <int D, bool kOut>
__device__ uint32_t vn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                             const uint8_t* __restrict__ chg, const int32_t* __restrict__ route,
                             int off, int n, int node_off, int bt, int first, int step) {
  uint32_t sum = 0;
  for (int t = first; t < n * bt; t += step) {
    const int node = t / bt;
    const int c = t - node * bt;
    uint8_t x = chg != nullptr ? chg[(node_off + node) * bt + c] : uint8_t(0);
    sum += x;
    if constexpr (D == 1) {
      if (kOut) dst[__ldg(&route[off + node]) * bt + c] = x;
    } else {
      uint8_t m[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        m[k] = src[(off + k * n + node) * bt + c];
        x ^= m[k];
        sum += m[k];
      }
      if (kOut) {
#pragma unroll
        for (int k = 0; k < D; ++k)
          dst[__ldg(&route[off + k * n + node]) * bt + c] = uint8_t(x ^ m[k] ^ k);
      }
    }
  }
  return sum;
}

template <bool kOut>
__device__ __forceinline__ void add_sum(const Params& p, int tile, uint32_t sum) {
  if (kOut) return;
  sum = bulk::block_sum(sum);
  if (threadIdx.x == 0) atomicAdd(&p.sums[tile], sum);
}

template <bool kOut>
__global__ void __launch_bounds__(kThreads) cn_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt;
  const uint8_t* src = p.A + view_base(p, tile);
  uint8_t* dst = p.B + view_base(p, tile);
  uint32_t sum = 0;
  for (int k = 0; k < p.g.n_cn_groups; ++k) {
    const int off = p.g.cn_groups[3 * k], n = p.g.cn_groups[3 * k + 1];
    switch (p.g.cn_groups[3 * k + 2]) {
#define REPLAY_CN_CASE(D)                                                                   \
  case D:                                                                                   \
    sum += cn_group<D, kOut>(src, dst, p.g.cn_route, off, n, bt, first_item(), item_step()); \
    break;
      IB_DEGREES_2_TO_16(REPLAY_CN_CASE)
#undef REPLAY_CN_CASE
      default:
        __trap();
    }
  }
  add_sum<kOut>(p, tile, sum);
}

template <bool kOut>
__global__ void __launch_bounds__(kThreads) vn_kernel(Params p) {
  const int tile = blockIdx.y, bt = p.g.bt;
  const uint8_t* src = p.B + view_base(p, tile);
  uint8_t* dst = p.A + view_base(p, tile);
  const uint8_t* chg = p.chv ? p.chg + size_t(tile) * p.n_vars * bt : nullptr;
  uint32_t sum = 0;
  for (int k = 0; k < p.g.n_vn_groups; ++k) {
    const int off = p.g.vn_groups[4 * k], n = p.g.vn_groups[4 * k + 1];
    const int node_off = p.g.vn_groups[4 * k + 3];
    switch (p.g.vn_groups[4 * k + 2]) {
#define REPLAY_VN_CASE(D)                                                                  \
  case D:                                                                                  \
    sum += vn_group<D, kOut>(src, dst, chg, p.g.vn_route, off, n, node_off, bt,           \
                             first_item(), item_step());                                   \
    break;
      IB_DEGREES_1_TO_16(REPLAY_VN_CASE)
#undef REPLAY_VN_CASE
      default:
        __trap();
    }
  }
  add_sum<kOut>(p, tile, sum);
}

// One staged unit: `count` nodes of a group from node n0.
struct Unit {
  int off, n, d, node_off, n0, count;
};

template <bool kVn>
__device__ __forceinline__ Unit unit_of(const Params& p, const int32_t* units, int u) {
  const int gi = units[2 * u], n0 = units[2 * u + 1];
  const int32_t* grp = kVn ? p.g.vn_groups + 4 * gi : p.g.cn_groups + 3 * gi;
  const int n = grp[1];
  return Unit{grp[0], n, grp[2], kVn ? grp[3] : 0, n0, min(p.piece, n - n0)};
}

// Messages a unit stages per node: a degree-1 variable node reads none.
template <bool kVn>
__device__ __forceinline__ int message_planes(const Unit& u) {
  return kVn && u.d == 1 ? 0 : u.d;
}

// The unit's items from its stage `st` (plane k at k piece bt, the channel
// after the messages), written routed as the write mode writes them.
template <int D, bool kVn>
__device__ void consume(const Params& p, const uint8_t* st, uint8_t* dst, const Unit& u) {
  const int bt = p.g.bt, plane = p.piece * bt;
  const int32_t* route = kVn ? p.g.vn_route : p.g.cn_route;
  constexpr int kPlanes = kVn && D == 1 ? 0 : D;
  for (int i = threadIdx.x; i < u.count * bt; i += blockDim.x) {
    const int node = u.n0 + i / bt;
    const int c = i - (i / bt) * bt;
    uint8_t x = kVn && p.chv ? st[kPlanes * plane + i] : uint8_t(0);
    if constexpr (kPlanes == 0) {
      dst[__ldg(&route[u.off + node]) * bt + c] = x;
    } else {
      uint8_t m[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        m[k] = st[k * plane + i];
        x ^= m[k];
      }
#pragma unroll
      for (int k = 0; k < D; ++k)
        dst[__ldg(&route[u.off + k * u.n + node]) * bt + c] = uint8_t(x ^ m[k] ^ k);
    }
  }
}

template <bool kVn>
__global__ void __launch_bounds__(kStagedThreads)
    staged_kernel(Params p, const int32_t* units, int n_units) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bars[2];
  const int tile = blockIdx.y, bt = p.g.bt;
  const uint8_t* src = (kVn ? p.B : p.A) + view_base(p, tile);
  uint8_t* dst = (kVn ? p.A : p.B) + view_base(p, tile);
  const uint8_t* chg = p.chg + size_t(tile) * p.n_vars * bt;
  const int plane = p.piece * bt, stage = p.stage_planes * plane;
  const int mine = n_units > int(blockIdx.x) ? (n_units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    bulk::init(&bars[0], 1);
    bulk::init(&bars[1], 1);
  }
  __syncthreads();
  // Thread 0 stages the block's t-th unit into stage h.
  auto issue = [&](int t, int h) {
    const Unit u = unit_of<kVn>(p, units, blockIdx.x + t * gridDim.x);
    const int planes = message_planes<kVn>(u), bytes = u.count * bt;
    const bool with_chg = kVn && p.chv;
    bulk::arrive_expect_tx(&bars[h], (planes + with_chg) * bytes);
    uint8_t* st = smem + h * stage;
    for (int k = 0; k < planes; ++k)
      bulk::load(st + k * plane, src + size_t(u.off + k * u.n + u.n0) * bt, bytes, &bars[h]);
    if (with_chg)
      bulk::load(st + planes * plane, chg + size_t(u.node_off + u.n0) * bt, bytes, &bars[h]);
  };
  if (threadIdx.x == 0 && mine > 0) issue(0, 0);
  for (int t = 0; t < mine; ++t) {
    // The other stage was released by the barrier that ended unit t - 1.
    if (threadIdx.x == 0 && t + 1 < mine) issue(t + 1, (t + 1) & 1);
    const int h = t & 1;
    bulk::wait(&bars[h], (t >> 1) & 1);
    const Unit u = unit_of<kVn>(p, units, blockIdx.x + t * gridDim.x);
    const uint8_t* st = smem + h * stage;
    switch (u.d) {
#define REPLAY_STAGED_CASE(D) \
  case D:                     \
    consume<D, kVn>(p, st, dst, u); \
    break;
      IB_DEGREES_1_TO_16(REPLAY_STAGED_CASE)
#undef REPLAY_STAGED_CASE
      default:
        __trap();
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int stage_replay_batch_tile() { return kBatchTile; }

// `bodies` bodies of the replay on `stream`: per body the VN pass (if
// n_vn_groups) then the CN pass (if n_cn_groups), each one launch over all
// n_tiles tiles of kBatchTile codewords. `mode` 0 writes the outputs, 1 sums
// the reads into sums[tile], 2 stages the reads through `piece`-node units
// (cn_units / vn_units: (group, first node) pairs) in stages of
// `stage_planes` planes. `chv` 0: the VN pass does not read `chg`.
int stage_replay(int mode, int chv, uint8_t* A, uint8_t* B, const uint8_t* chg, uint32_t* sums,
                 const int32_t* cn_groups, const int32_t* vn_groups, const int32_t* cn_route,
                 const int32_t* vn_route, int n_cn_groups, int n_vn_groups,
                 const int32_t* cn_units, int n_cn_units, const int32_t* vn_units, int n_vn_units,
                 int piece, int stage_planes, int n_vars, int n_checks, int n_edges, int n_tiles,
                 int bodies, void* stream) {
  if (mode < kWrite || mode > kStaged || n_tiles < 1 || bodies < 0 || piece < 1 ||
      (long long)n_edges * kBatchTile >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  const ib_lut::Graph g{cn_groups,   vn_groups,   cn_route,   vn_route, nullptr,
                        n_cn_groups, n_vn_groups, kBatchTile, 0};
  const Params p{g, A, B, chg, sums, n_vars, n_edges, chv, piece, stage_planes};
  const auto s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t err = hbm_tiles::sm_count(&sms);
  const long long stage = (long long)stage_planes * piece * kBatchTile;
  if (err == cudaSuccess && mode == kStaged) {
    if (stage > bulk::kMaxTxBytes) return int(cudaErrorInvalidValue);  // one barrier's phase
    err = cudaFuncSetAttribute(staged_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(2 * stage));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(staged_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, int(2 * stage));
  }
  if (err != cudaSuccess) return int(err);
  const dim3 cn_grid = hbm_tiles::pass_grid(n_checks * kBatchTile, n_tiles, sms);
  const dim3 vn_grid = hbm_tiles::pass_grid(n_vars * kBatchTile, n_tiles, sms);
  const dim3 staged_grid((sms + n_tiles - 1) / n_tiles, n_tiles);  // about one block per SM
  const int smem = int(2 * stage);
  for (int b = 0; b < bodies; ++b) {
    if (n_vn_groups) {
      if (mode == kWrite) HBM_LAUNCH(vn_kernel<true><<<vn_grid, kThreads, 0, s>>>(p));
      else if (mode == kNoWrite) HBM_LAUNCH(vn_kernel<false><<<vn_grid, kThreads, 0, s>>>(p));
      else HBM_LAUNCH(staged_kernel<true><<<staged_grid, kStagedThreads, smem, s>>>(p, vn_units, n_vn_units));
    }
    if (n_cn_groups) {
      if (mode == kWrite) HBM_LAUNCH(cn_kernel<true><<<cn_grid, kThreads, 0, s>>>(p));
      else if (mode == kNoWrite) HBM_LAUNCH(cn_kernel<false><<<cn_grid, kThreads, 0, s>>>(p));
      else HBM_LAUNCH(staged_kernel<false><<<staged_grid, kStagedThreads, smem, s>>>(p, cn_units, n_cn_units));
    }
  }
  return int(cudaSuccess);
}

const char* stage_replay_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
