// K6: device-memory copy bandwidth on Hopper (sm_90a), for the roofline's
// traffic bounds (K3 and K4 keep their message views in device memory),
// which divide by the faster of this copy and torch's copy_.
//
// Replaces the Pallas TPU kernel of the JAX reference's
// scripts/bench_matrix.py:measure_hbm_bandwidth, which streams 2 MB chunks
// HBM -> VMEM -> HBM through a depth-4 ring. On Hopper a copy needs no
// staging: every thread moves 16-byte vectors straight from `src` to `dst`,
// neighbouring threads on neighbouring addresses, in a grid-stride loop over
// all SMs, `passes` times in one launch. The buffers are 256 MB each, five
// times the 50 MB L2, so every pass goes to device memory. Each thread loads
// kUnroll vectors before it stores them, so several loads are in flight per
// thread; `src` and `dst` are not declared __restrict__, so the compiler
// keeps every pass. Read and write bytes both count, as the TPU kernel
// counted them.
//
// What bounds it: device-memory bandwidth alone (data sheet: 3.35 TB/s for
// the H100 SXM). Streaming cache hints, contiguous per-block tiles and 2 to 8
// vectors per thread leave it below copy_ (cudaMemcpy's own kernel); TMA and
// bulk copies are for a later version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    hbm_copy_kernel(const int4* src, int4* dst, long long n, int passes) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int p = 0; p < passes; ++p) {
    for (long long base = first; base < n; base += kUnroll * step) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * step;
        if (i < n) v[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * step;
        if (i < n) dst[i] = v[u];
      }
    }
  }
}

}  // namespace

extern "C" {

// Copies `n16` 16-byte vectors from `src` to `dst`, `passes` times, on
// `stream`, with a grid that fills every SM.
int hbm_copy(const void* src, void* dst, long long n16, int passes, void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hbm_copy_kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  hbm_copy_kernel<<<sms * per_sm, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), n16, passes);
  return int(cudaGetLastError());
}

const char* hbm_copy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
