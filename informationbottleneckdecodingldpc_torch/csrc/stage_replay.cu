// P6: the port's K3 pass program replayed on Hopper (sm_90a), with the
// lookup-table folds replaced by a one-operation fold, to split K3's body
// time into its memory pattern and its folds.
//
// Replaces the Pallas TPU probe of the JAX reference's
// scripts/stage_replay.py:build, which replays the TPU K3's exact stage
// program (chunk strides, channel staging, buffer halves) with fold and
// scatter removed. The port's K3 (ib_lut_hbm.cu) has no DMA chassis, so this
// replays the port's K3 as it runs and keeps everything it does to memory:
// the ib_lut::Graph arrays, uint8 views [tile][row][bt] in device memory,
// and per body a VN pass B -> A that also reads the channel plane and a CN
// pass A -> B, each as K3's wide passes (hbm_wide.cuh): a thread keeps
// V = 8 consecutive codeword columns of its node rows (RowItems), loads
// each input row with one 8-byte load and stores each routed output row
// dst[route[off + k n + node] bt + c0 ..] with one 8-byte store; nodes above
// hbm_wide's split degree run in a second launch at 4 columns, as K3's
// general kernel, made only when the code has such nodes; each launch is
// shaped by hbm_wide::pass_shape over all tiles (grid y = tile). Output
// message k of a node is the XOR of its other inputs (the channel included)
// XOR k, in place of the LUT fold: the XOR of two 32-bit words is that of
// four columns at once, in registers. A degree-1 variable node forwards its
// channel value. K3's table staging, syndrome and exit passes are left out
// with the folds. Modes (kernels/stage_replay.py lists the variants, which
// also select groups and the channel read):
//
//   write     the passes as K3 runs them
//   nowrite   the reads only, their bytes summed per tile into a wrapping
//             checksum so they are not dead
//   staged    the read side through bulk copies: a unit is `piece` nodes of a
//             group, whose plane k is `piece` contiguous 128-byte rows of the
//             tile's slab (and the channel rows likewise); each block
//             double-buffers units through two stages in shared memory (9
//             planes x 24 rows x 128 B = 27 KB each on DVB-S2), one mbarrier
//             a stage, and consumes a unit 8 columns a thread, written
//             routed as above
//
// What bounds it: device-memory bandwidth. A DVB-S2 body at batch 1024 reads
// and writes both views once and reads the channel plane, 4 x 226,799 +
// 64,800 bytes per codeword, 995 MB, 0.297 ms at the data sheet's 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bulk.cuh"
#include "hbm_tiles.cuh"
#include "hbm_wide.cuh"
#include "ib_lut_groups.cuh"

namespace {

using hbm_wide::Bytes;
using hbm_wide::RowItems;

constexpr int kBatchTile = 128;
constexpr int kVec = 8;      // columns per thread of the low passes, K3's per-lane width
constexpr int kHighVec = 4;  // of the passes above the split degree, K3's general width
constexpr int kPiece = 24;   // nodes per staged unit
constexpr int kStagedThreads = kPiece * kBatchTile / kVec;  // one 8-column item each

enum Mode { kWrite = 0, kNoWrite = 1, kStaged = 2 };

struct Params {
  ib_lut::Graph g;     // the variant's groups, K3's routes and tile width
  uint8_t* A;          // [n_tiles, n_edges, bt] CN view
  uint8_t* B;          // [n_tiles, n_edges, bt] VN view
  const uint8_t* chg;  // [n_tiles, n_vars, bt] channel plane, group order
  uint32_t* sums;      // [n_tiles] checksums of the reads (nowrite)
  int n_vars, n_edges, chv;
  int stage_planes;    // staged: planes per stage
};

__device__ __forceinline__ size_t view_base(const Params& p, int tile) {
  return size_t(tile) * p.n_edges * p.g.bt;
}

// k in each byte of a word.
__device__ __forceinline__ uint32_t splat(int k) { return uint32_t(k) * 0x01010101u; }

template <int V>
__device__ __forceinline__ void xor_into(Bytes<V>& x, const Bytes<V>& m) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) x.w[i] ^= m.w[i];
}

// Output k of a leave-one-out XOR fold whose total is x.
template <int V>
__device__ __forceinline__ Bytes<V> leave_out(const Bytes<V>& x, const Bytes<V>& m, int k) {
  Bytes<V> o;
#pragma unroll
  for (int i = 0; i < V / 4; ++i) o.w[i] = x.w[i] ^ m.w[i] ^ splat(k);
  return o;
}

template <int V>
__device__ __forceinline__ uint32_t byte_sum(const Bytes<V>& m, uint32_t sum) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) sum = __dp4a(m.w[i], 0x01010101u, sum);
  return sum;
}

// One check group of degree D, V columns per item: D vector loads, then D
// routed vector stores of the fold (kOut) or the bytes' sum (returned).
template <int V, int D, bool kOut>
__device__ uint32_t cn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                             const int32_t* __restrict__ route, int off, int n, int bt,
                             RowItems it) {
  uint32_t sum = 0;
  for (int node = it.node; node < n; node += it.node_step) {
    Bytes<V> in[D];
#pragma unroll
    for (int k = 0; k < D; ++k) in[k].load(src + (off + k * n + node) * bt + it.c0);
    if constexpr (kOut) {
      int row[D];
      Bytes<V> x;
      x.clear();
#pragma unroll
      for (int k = 0; k < D; ++k) {
        row[k] = __ldg(&route[off + k * n + node]);
        xor_into(x, in[k]);
      }
#pragma unroll
      for (int k = 0; k < D; ++k) leave_out(x, in[k], k).store(dst + row[k] * bt + it.c0);
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) sum = byte_sum(in[k], sum);
    }
  }
  return sum;
}

// One variable group of degree D with its channel rows (`chg` null: not
// read, counted as 0).
template <int V, int D, bool kOut>
__device__ uint32_t vn_group(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                             const uint8_t* __restrict__ chg, const int32_t* __restrict__ route,
                             int off, int n, int node_off, int bt, RowItems it) {
  uint32_t sum = 0;
  for (int node = it.node; node < n; node += it.node_step) {
    Bytes<V> ch;
    ch.clear();
    if (chg != nullptr) ch.load(chg + (node_off + node) * bt + it.c0);
    if constexpr (!kOut) sum = byte_sum(ch, sum);
    if constexpr (D == 1) {
      if constexpr (kOut) ch.store(dst + __ldg(&route[off + node]) * bt + it.c0);
    } else {
      Bytes<V> in[D];
#pragma unroll
      for (int k = 0; k < D; ++k) in[k].load(src + (off + k * n + node) * bt + it.c0);
      if constexpr (kOut) {
        int row[D];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          row[k] = __ldg(&route[off + k * n + node]);
          xor_into(ch, in[k]);
        }
#pragma unroll
        for (int k = 0; k < D; ++k) leave_out(ch, in[k], k).store(dst + row[k] * bt + it.c0);
      } else {
#pragma unroll
        for (int k = 0; k < D; ++k) sum = byte_sum(in[k], sum);
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

// The CN pass over the groups of range HI (above the split degree) or not.
template <bool HI, bool kOut>
__global__ void __launch_bounds__(hbm_wide::kThreads) cn_kernel(Params p) {
  constexpr int V = HI ? kHighVec : kVec;
  const int tile = blockIdx.y, bt = p.g.bt;
  const uint8_t* src = p.A + view_base(p, tile);
  uint8_t* dst = p.B + view_base(p, tile);
  const RowItems it = hbm_wide::row_items<V>(bt);
  uint32_t sum = 0;
  for (int k = 0; k < p.g.n_cn_groups; ++k) {
    const int off = p.g.cn_groups[3 * k], n = p.g.cn_groups[3 * k + 1], d = p.g.cn_groups[3 * k + 2];
    if (!hbm_wide::in_range<HI>(d)) continue;
#define REPLAY_CN_CASE(D)                                                  \
  case D:                                                                  \
    sum += cn_group<V, D, kOut>(src, dst, p.g.cn_route, off, n, bt, it);   \
    break;
    if constexpr (HI) {
      switch (d) {
        WIDE_DEGREES_HI(REPLAY_CN_CASE)
        default:
          __trap();
      }
    } else {
      switch (d) {
        WIDE_DEGREES_LO(REPLAY_CN_CASE)
        default:
          __trap();
      }
    }
#undef REPLAY_CN_CASE
  }
  add_sum<kOut>(p, tile, sum);
}

template <bool HI, bool kOut>
__global__ void __launch_bounds__(hbm_wide::kThreads) vn_kernel(Params p) {
  constexpr int V = HI ? kHighVec : kVec;
  const int tile = blockIdx.y, bt = p.g.bt;
  const uint8_t* src = p.B + view_base(p, tile);
  uint8_t* dst = p.A + view_base(p, tile);
  const uint8_t* chg = p.chv ? p.chg + size_t(tile) * p.n_vars * bt : nullptr;
  const RowItems it = hbm_wide::row_items<V>(bt);
  uint32_t sum = 0;
  for (int k = 0; k < p.g.n_vn_groups; ++k) {
    const int off = p.g.vn_groups[4 * k], n = p.g.vn_groups[4 * k + 1];
    const int d = p.g.vn_groups[4 * k + 2], node_off = p.g.vn_groups[4 * k + 3];
    if (!hbm_wide::in_range<HI>(d)) continue;
#define REPLAY_VN_CASE(D)                                                                   \
  case D:                                                                                   \
    sum += vn_group<V, D, kOut>(src, dst, chg, p.g.vn_route, off, n, node_off, bt, it);     \
    break;
    if constexpr (HI) {
      switch (d) {
        WIDE_DEGREES_HI(REPLAY_VN_CASE)
        default:
          __trap();
      }
    } else {
      switch (d) {
        REPLAY_VN_CASE(1)
        WIDE_DEGREES_LO(REPLAY_VN_CASE)
        default:
          __trap();
      }
    }
#undef REPLAY_VN_CASE
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
  return Unit{grp[0], n, grp[2], kVn ? grp[3] : 0, n0, min(kPiece, n - n0)};
}

// Messages a unit stages per node: a degree-1 variable node reads none.
template <bool kVn>
__device__ __forceinline__ int message_planes(const Unit& u) {
  return kVn && u.d == 1 ? 0 : u.d;
}

__device__ __forceinline__ Bytes<kVec> shared_row(const uint8_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  Bytes<kVec> b;
  b.w[0] = v.x;
  b.w[1] = v.y;
  return b;
}

// The unit's items from its stage `st` (plane k at k piece bt, the channel
// after the messages), 8 columns a thread, written routed as the write mode
// writes them.
template <bool kVn>
__device__ void consume(const Params& p, const uint8_t* st, uint8_t* dst, const Unit& u) {
  const int bt = p.g.bt, plane = kPiece * bt, lanes = bt / kVec;
  const int32_t* route = kVn ? p.g.vn_route : p.g.cn_route;
  const int planes = message_planes<kVn>(u);
  for (int i = threadIdx.x; i < u.count * lanes; i += blockDim.x) {
    const int local = i / lanes, c0 = (i - local * lanes) * kVec, node = u.n0 + local;
    const int at = local * bt + c0;
    Bytes<kVec> x;
    x.clear();
    if (kVn && p.chv) x = shared_row(st + planes * plane + at);
    if (planes == 0) {
      x.store(dst + __ldg(&route[u.off + node]) * bt + c0);
      continue;
    }
    for (int k = 0; k < planes; ++k) xor_into(x, shared_row(st + k * plane + at));
    for (int k = 0; k < planes; ++k)
      leave_out(x, shared_row(st + k * plane + at), k)
          .store(dst + __ldg(&route[u.off + k * u.n + node]) * bt + c0);
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
  const int plane = kPiece * bt, stage = p.stage_planes * plane;
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
    consume<kVn>(p, smem + h * stage, dst, unit_of<kVn>(p, units, blockIdx.x + t * gridDim.x));
    __syncthreads();
  }
}

// One pass as launched: the low kernel, and the high one when the pass has
// nodes above the split degree.
struct PassLaunch {
  bool high;
  hbm_wide::PassShape low_shape, high_shape;
};

template <class Low, class High>
cudaError_t plan_pass(Low low, High high, int d_max, int rows, int n_tiles, int sms,
                      PassLaunch* out) {
  out->high = d_max > hbm_wide::kSplitDegree;
  cudaError_t err = hbm_wide::pass_shape(low, kVec, kBatchTile, 0, rows, n_tiles, sms,
                                         &out->low_shape);
  if (err == cudaSuccess && out->high)
    err = hbm_wide::pass_shape(high, kHighVec, kBatchTile, 0, rows, n_tiles, sms,
                               &out->high_shape);
  return err;
}

// The grid of a staged pass: as many blocks as the card holds at once,
// shared among the tiles.
template <class Kernel>
cudaError_t staged_grid(Kernel kernel, int smem, int n_tiles, int sms, dim3* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStagedThreads, smem);
  const int share = sms * per_sm / n_tiles;
  *grid = dim3(share > 1 ? share : 1, n_tiles);
  return err;
}

template <bool kOut>
int replay(const Params& p, int n_checks, int cn_d_max, int vn_d_max, int n_tiles, int bodies,
           int sms, cudaStream_t s) {
  PassLaunch cn, vn;
  cudaError_t err = plan_pass(cn_kernel<false, kOut>, cn_kernel<true, kOut>, cn_d_max, n_checks,
                              n_tiles, sms, &cn);
  if (err == cudaSuccess)
    err = plan_pass(vn_kernel<false, kOut>, vn_kernel<true, kOut>, vn_d_max, p.n_vars, n_tiles,
                    sms, &vn);
  if (err != cudaSuccess) return int(err);
  for (int b = 0; b < bodies; ++b) {
    if (p.g.n_vn_groups) {
      HBM_LAUNCH(vn_kernel<false, kOut><<<vn.low_shape.grid, vn.low_shape.threads, 0, s>>>(p));
      if (vn.high)
        HBM_LAUNCH(vn_kernel<true, kOut><<<vn.high_shape.grid, vn.high_shape.threads, 0, s>>>(p));
    }
    if (p.g.n_cn_groups) {
      HBM_LAUNCH(cn_kernel<false, kOut><<<cn.low_shape.grid, cn.low_shape.threads, 0, s>>>(p));
      if (cn.high)
        HBM_LAUNCH(cn_kernel<true, kOut><<<cn.high_shape.grid, cn.high_shape.threads, 0, s>>>(p));
    }
  }
  return int(cudaSuccess);
}

int replay_staged(const Params& p, const int32_t* cn_units, int n_cn_units,
                  const int32_t* vn_units, int n_vn_units, int n_tiles, int bodies, int sms,
                  cudaStream_t s) {
  const long long stage = (long long)p.stage_planes * kPiece * kBatchTile;
  if (stage > bulk::kMaxTxBytes) return int(cudaErrorInvalidValue);  // one barrier's phase
  dim3 cn_grid, vn_grid;
  cudaError_t err = staged_grid(staged_kernel<false>, int(2 * stage), n_tiles, sms, &cn_grid);
  if (err == cudaSuccess) err = staged_grid(staged_kernel<true>, int(2 * stage), n_tiles, sms, &vn_grid);
  if (err != cudaSuccess) return int(err);
  const int smem = int(2 * stage);
  for (int b = 0; b < bodies; ++b) {
    if (p.g.n_vn_groups)
      HBM_LAUNCH(staged_kernel<true><<<vn_grid, kStagedThreads, smem, s>>>(p, vn_units, n_vn_units));
    if (p.g.n_cn_groups)
      HBM_LAUNCH(staged_kernel<false><<<cn_grid, kStagedThreads, smem, s>>>(p, cn_units, n_cn_units));
  }
  return int(cudaSuccess);
}

}  // namespace

extern "C" {

int stage_replay_batch_tile() { return kBatchTile; }
int stage_replay_piece() { return kPiece; }

// `bodies` bodies of the replay on `stream`: per body the VN pass (if
// n_vn_groups) then the CN pass (if n_cn_groups), each over all n_tiles
// tiles of kBatchTile codewords, with a second launch for the groups above
// hbm_wide's split degree when the pass's largest degree (cn_d_max,
// vn_d_max) is above it. `mode` 0 writes the outputs, 1 sums the reads into
// sums[tile], 2 stages the reads through kPiece-node units (cn_units /
// vn_units: (group, first node) pairs) in stages of `stage_planes` planes.
// `chv` 0: the VN pass does not read `chg`.
int stage_replay(int mode, int chv, uint8_t* A, uint8_t* B, const uint8_t* chg, uint32_t* sums,
                 const int32_t* cn_groups, const int32_t* vn_groups, const int32_t* cn_route,
                 const int32_t* vn_route, int n_cn_groups, int n_vn_groups,
                 const int32_t* cn_units, int n_cn_units, const int32_t* vn_units, int n_vn_units,
                 int stage_planes, int cn_d_max, int vn_d_max, int n_vars, int n_checks,
                 int n_edges, int n_tiles, int bodies, void* stream) {
  if (mode < kWrite || mode > kStaged || n_tiles < 1 || bodies < 0 ||
      cn_d_max > 16 || vn_d_max > 16 || (long long)n_edges * kBatchTile >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  const ib_lut::Graph g{cn_groups,   vn_groups,   cn_route,   vn_route, nullptr,
                        n_cn_groups, n_vn_groups, kBatchTile, 0};
  const Params p{g, A, B, chg, sums, n_vars, n_edges, chv, stage_planes};
  const auto s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  const cudaError_t err = hbm_tiles::sm_count(&sms);
  if (err != cudaSuccess) return int(err);
  if (mode == kWrite) return replay<true>(p, n_checks, cn_d_max, vn_d_max, n_tiles, bodies, sms, s);
  if (mode == kNoWrite) return replay<false>(p, n_checks, cn_d_max, vn_d_max, n_tiles, bodies, sms, s);
  return replay_staged(p, cn_units, n_cn_units, vn_units, n_vn_units, n_tiles, bodies, sms, s);
}

const char* stage_replay_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
