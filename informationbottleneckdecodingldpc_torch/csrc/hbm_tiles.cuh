// The device-memory chassis shared by K3 (ib_lut_hbm.cu) and K4
// (float_hbm.cu): views laid out [tile][row][bt], one grid-stride launch per
// pass over all tiles (grid y = tile), and per tile in device memory a done
// flag and a body count (`state`, [n_tiles][2]) and the syndrome counts of
// its last body (`unsat`, [n_tiles][bt]).
//
// A kernel's Params type P holds `g.bt`, `n_edges`, `state`, `unsat` and
// `early_exit`.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace hbm_tiles {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;  // target of resident blocks for grid-stride passes

__device__ __forceinline__ int first_item() { return blockIdx.x * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int item_step() { return gridDim.x * blockDim.x; }

// Offset of a tile's view slab; tiles beyond 2^31 elements need 64 bits.
template <class P>
__device__ __forceinline__ size_t view_base(const P& p, int tile) {
  return size_t(tile) * p.n_edges * p.g.bt;
}

// Read by every thread of a block alike, so a return on it is uniform.
template <class P>
__device__ __forceinline__ bool tile_done(const P& p, int tile) {
  return p.state[2 * tile] != 0;
}

// After body i, one block per tile: records the bodies run and, with early
// exit, marks the tile done when none of its codewords has an unsatisfied
// check. The launch boundary before it makes the counts complete.
template <class P>
__global__ void exit_kernel(P p, int i) {
  const int tile = blockIdx.x, bt = p.g.bt;
  if (tile_done(p, tile)) return;
  int any = 0;
  for (int c = threadIdx.x; c < bt; c += blockDim.x) any |= p.unsat[tile * bt + c] > 0;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    p.state[2 * tile + 1] = i + 1;
    if (p.early_exit && !any) p.state[2 * tile] = 1;
  }
}

// Blocks of a grid-stride pass over `items` items per tile.
inline dim3 pass_grid(int items, int n_tiles, int sms) {
  const int needed = (items + kThreads - 1) / kThreads;
  const int share = (sms * kBlocksPerSm + n_tiles - 1) / n_tiles;
  return dim3(needed < share ? needed : share, n_tiles);
}

// Streaming multiprocessors of the current device.
inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace hbm_tiles

// Launches a kernel (the whole launch expression) and returns its error from
// the enclosing function if the launch was refused.
#define HBM_LAUNCH(...)                                \
  do {                                                 \
    __VA_ARGS__;                                       \
    const cudaError_t launch_err = cudaGetLastError(); \
    if (launch_err != cudaSuccess) return int(launch_err); \
  } while (0)
