// The wide message passes of K3 (ib_lut_hbm.cu) and K4 (float_hbm.cu): on
// the views [tile][row][bt] of hbm_tiles.cuh, a thread takes V consecutive
// codeword columns of one node and moves them with one vector load or store
// per row (K3: 8 bytes as uint2, 4 as one word in its general passes; K4: 4
// floats as float4). A node row is bt / V threads and a block holds whole
// rows, so a thread keeps one column chunk through its grid-stride loop: its
// first row and its chunk are worked out once per launch, never per item,
// each route index is read once per V columns, and a routed row store writes
// bt contiguous elements. The node folds stay per column, in registers. The
// passes take any tile that V divides, up to kMaxTile codewords.
//
// A pass kernel holds its degree range, so that its register count is set by
// the largest degree it can meet: nodes of degree <= kSplitDegree run in the
// low kernel, higher degrees in a second launch of the high one, made only
// when the code has such nodes (DVB-S2 and the regular codes never do; WLAN's
// degree-11 variable nodes do). The high kernels are built at the narrowest
// width (K3: 4 bytes; K4 BP: the 4 columns of its CN folds in a loop), so
// that the folds of degrees up to 16, unrolled per column, stay small enough
// for ptxas.
//
// K3 keeps its views at 8 or 4 bits a message (Bytes or Nibbles): at 4 bits
// a row of bt columns is bt / 2 bytes, column 2k in the low nibble of byte k
// and column 2k + 1 in its high nibble, so V columns move as one V / 2-byte
// access and the folds see the same per-column values through get and put.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace hbm_wide {

constexpr int kThreads = 256;           // most threads per block of a wide pass
constexpr int kMaxTile = 4 * kThreads;  // a row of 4-column items fills a block
constexpr int kSplitDegree = 8;         // the low kernels take degrees up to this

// Whether the passes at V columns per item take tiles of bt codewords.
inline bool takes_tile(int bt, int v) { return bt > 0 && bt % v == 0 && bt <= kMaxTile; }

// Whether the kernel of range HI takes nodes of degree d.
template <bool HI>
__device__ __forceinline__ bool in_range(int d) {
  return (d > kSplitDegree) == HI;
}

// The items of one thread in a pass at V columns per item over tiles of bt:
// columns c0 .. c0 + V - 1 of node rows node, node + node_step, ...
struct RowItems {
  int node, node_step, c0;
};

template <int V>
__device__ __forceinline__ RowItems row_items(int bt) {
  const int lanes = bt / V;  // threads per node row; blockDim.x is a multiple
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  return {t / lanes, int(gridDim.x * (blockDim.x / lanes)), t % lanes * V};
}

// V consecutive bytes of a view row (V = 4 or 8), held as 32-bit words.
template <int V>
struct Bytes {
  static_assert(V == 4 || V == 8, "4 or 8 bytes per access");
  uint32_t w[V / 4];

  // Read-only for the whole launch: the non-coherent path is safe.
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (V == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    }
  }
  __device__ __forceinline__ void store(uint8_t* p) const {
    if constexpr (V == 4)
      *reinterpret_cast<unsigned int*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) w[i] = 0;
  }
  // Byte j (j a compile-time constant after unrolling).
  __device__ __forceinline__ uint8_t get(int j) const {
    return uint8_t(w[j / 4] >> (8 * (j % 4)));
  }
  // Sets byte j of a cleared row.
  __device__ __forceinline__ void put(int j, uint8_t b) { w[j / 4] |= uint32_t(b) << (8 * (j % 4)); }
  __device__ __forceinline__ void xor_with(const Bytes& o) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) w[i] ^= o.w[i];
  }
};

// V consecutive 4-bit elements of a packed view row (V = 4 or 8), held in
// the low V * 4 bits of a word: column j at bits 4j .. 4j + 3.
template <int V>
struct Nibbles {
  static_assert(V == 4 || V == 8, "4 or 8 columns per access");
  uint32_t w;

  // Read-only for the whole launch: the non-coherent path is safe.
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (V == 4)
      w = __ldg(reinterpret_cast<const unsigned short*>(p));
    else
      w = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ void store(uint8_t* p) const {
    if constexpr (V == 4)
      *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w);
    else
      *reinterpret_cast<unsigned int*>(p) = w;
  }
  __device__ __forceinline__ void clear() { w = 0; }
  // Column j (j a compile-time constant after unrolling).
  __device__ __forceinline__ uint8_t get(int j) const { return uint8_t((w >> (4 * j)) & 15u); }
  // Sets column j of a cleared row to b < 16 (an add: the nibbles do not
  // overlap, so one shift-and-add).
  __device__ __forceinline__ void put(int j, uint8_t b) { w += uint32_t(b) << (4 * j); }
  __device__ __forceinline__ void xor_with(const Nibbles& o) { w ^= o.w; }
};

// The row type of V columns of BITS-bit messages (8: Bytes, 4: Nibbles).
template <int V, int BITS>
using Row = std::conditional_t<BITS == 4, Nibbles<V>, Bytes<V>>;

// Bytes of `columns` columns of BITS-bit messages (columns even at 4 bits).
template <int BITS>
__host__ __device__ __forceinline__ int row_bytes(int columns) {
  static_assert(BITS == 4 || BITS == 8, "4 or 8 bits a message");
  return BITS == 8 ? columns : columns >> 1;
}

// Element i of a view of BITS-bit messages laid out as above, i = row * bt +
// column (bt even, so the column's parity is i's).
template <int BITS>
__device__ __forceinline__ uint8_t element(const uint8_t* v, int i) {
  if constexpr (BITS == 8)
    return v[i];
  else
    return uint8_t((v[i >> 1] >> (4 * (i & 1))) & 15);
}

// Component j of a float4 (j a compile-time constant after unrolling).
__device__ __forceinline__ float& lane(float4& v, int j) { return (&v.x)[j]; }
__device__ __forceinline__ float lane(const float4& v, int j) { return (&v.x)[j]; }

// A wide pass as launched: blocks of whole node rows, shared among the tiles
// (grid y = tile).
struct PassShape {
  dim3 grid;
  int threads;
};

// The shape of a wide pass of `kernel` at v columns per item over `rows` node
// rows of each of `n_tiles` tiles of bt: no more blocks than the card holds at
// once for `kernel` (its registers and `smem` decide how many fit an SM).
// Also lifts the kernel's dynamic shared-memory limit to `smem`.
template <class Kernel>
inline cudaError_t pass_shape(Kernel kernel, int v, int bt, int smem, int rows, int n_tiles,
                              int sms, PassShape* shape) {
  const int lanes = bt / v, rows_per_block = kThreads / lanes;
  const int threads = rows_per_block * lanes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int needed = (rows + rows_per_block - 1) / rows_per_block;
  int share = sms * per_sm / n_tiles;
  if (share < 1) share = 1;
  *shape = PassShape{dim3(needed < share ? needed : share, n_tiles), threads};
  return cudaSuccess;
}

}  // namespace hbm_wide

#define WIDE_DEGREES_LO(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8)
#define WIDE_DEGREES_HI(X) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)
