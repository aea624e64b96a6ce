// The encoded chain's systematic LDPC encoder on Hopper (sm_90a): a step's
// int8 info plane u [K, batch] to its int8 codeword [N, batch] in one launch,
// the info rows copied and the parity rows written, with no intermediate
// plane in device memory.
//
// Replaces no Pallas kernel: the JAX package encodes with XLA
// (informationbottleneckdecodingldpc_tpu/encode/encoder.py device_encoder),
// and the port's parent ran the same torch closure, kept as the plain version
// (kernels/encoder.py DeviceEncoder.plain): per info-column slot a gather and
// an XOR, a transposed int32 cumsum or a float32 GEMM, a cast and a cat, 17
// launches a DVB-S2 step and 20 a WLAN one. H = [A | B]; s = A u over GF(2),
// s_r the XOR of row r's info columns (a table of each row's columns in
// quads, padded with -1, so a row's gathers are issued together); then p
// solves B p = s on one of two paths, which share nothing but that table and
// the copy of u:
//
// Staircase B (DVB-S2 and any accumulator code): p is the prefix XOR of s
// down the m rows. XOR has no carries, so a thread XORs a word of W codeword
// columns (16 bytes where they divide the batch, else 1) as one value. A block takes a tile of 128 bytes of columns by kThreads / CW
// thread rows of kRows rows each: neighbouring threads take neighbouring
// words, so every gathered info row is read as whole 128-byte lines. The
// scan is single-pass, one launch with no grid-wide barrier: each thread
// XORs and scans its rows in registers, a scan of the thread rows' totals
// runs in shared memory, and the block's carry comes from the blocks above
// it in the same column tile by decoupled look-back (Merrill and Garland,
// "Single-pass parallel prefix scan with decoupled look-back", 2016): each
// block publishes its aggregate at once and its inclusive prefix once
// known, and a block XORs aggregates upwards until it meets a prefix. Blocks
// take their chunk from an atomic ticket, so a block waits only on blocks
// that already run; the last block to finish resets the ticket and advances
// the epoch that tags the flags, so the state needs no clearing between
// launches of one shape (and a replayed launch reads no stale flag). Where
// the flags end and the carries start depends on the batch and the word, so
// a state buffer serves one shape: the wrapper gives a new shape a zeroed
// buffer, else a carry word of the old shape could read as a flag of the
// current epoch. One stream at a time may use a state buffer.
//
// Dense B^-1 (m <= kMaxDenseChecks; WLAN m = 648): B^-1 is packed on the
// host, bit j of word w of row i = B^-1[i][32 w + j], rows padded to a
// multiple of 4 words. A block takes 32 codewords: a lane takes a check row
// and XORs the 32 codewords' bytes of its info rows (16-byte loads), and 32
// ballots turn the warp's 32 rows into one word of s per codeword in shared
// memory. Then a warp takes parity rows, a lane a codeword: it ANDs the
// row's words (one 16-byte uniform load for 4, the same for every lane) with
// its s, XORs the results, and the parity of the popcount is the bit. At m =
// 648 the packed rows (52 KB) stay in L1 after the first block; at m = 4096
// (2 MB) they stream from L2, each row applied to the block's 32 codewords.
// Where the batch gives fewer than two blocks an SM, the rows are split over
// blocks that each build s.
//
// What bounds it: bytes. The info plane is read once and the codeword
// written once: DVB-S2 at batch 1024 33.2 MB + 66.4 MB, 0.030 ms at 3.35
// TB/s. The gathers read each info row again per check it sits on (5 a row
// on DVB-S2's A, 166 MB); the design leaves those to L2 (33 MB of info
// against 50 MB), writes the codeword with evict-first stores so it does not
// push the info out, and copies u between publishing the aggregate and the
// look-back, which hides most of the look-back's wait. On an H100 at batch
// 1024 the kernel takes about three times the bound: the copy of u costs
// what a copy costs, and the gathers' L2 traffic the rest (variants with the
// look-back, the copy or the stores cut, and tiles, rows and block sizes of
// half or twice these, timed on the card). The dense path's product needs,
// for each codeword and parity bit, ceil(m / 32) AND-XORs (one LOP3 each:
// 21 on WLAN, 125 at m = 4000); the kernel runs the row's padded words (24
// and 128) and loads s from shared memory for each, which its bound leaves
// out as a cost of this design.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 128;  // columns of a staircase block
constexpr int kRows = 8;         // rows of a staircase thread
constexpr int kMaxDenseChecks = 4096;
constexpr int kMaxDenseWords = kMaxDenseChecks / 32;
constexpr int kHeaderWords = 4;  // epoch, blocks done, ticket, spare

template <int W>
using Word = std::conditional_t<W == 16, uint4, uint8_t>;

__device__ __forceinline__ uint4 wxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint8_t wxor(uint8_t a, uint8_t b) { return uint8_t(a ^ b); }

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The systematic rows: codeword[0, K) = u, as one flat copy of k * batch
// bytes spread over the grid, in 16-byte words where both are aligned.
__device__ void copy_info(const uint8_t* u, uint8_t* out, long long nbytes) {
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const long long words = nbytes / 16;
    const uint4* s = reinterpret_cast<const uint4*>(u);
    uint4* d = reinterpret_cast<uint4*>(out);
    for (long long i = first; i < words; i += step) __stcs(d + i, __ldg(s + i));
    done = words * 16;
  }
  for (long long i = done + first; i < nbytes; i += step) __stcs(out + i, __ldg(u + i));
}

struct Params {
  const uint8_t* info;  // [k, batch]
  uint8_t* codeword;    // [k + m, batch]
  const int4* cols;     // [m, deg4] quads: each check's info columns, padded with -1
  const uint32_t* binv;  // dense: [m, stride] packed rows
  uint32_t* state;       // staircase: header, flags [chunks * tiles], carries
  int k, m, batch, deg4, stride, tiles, chunks;
};

constexpr uint32_t kAggregate = 1, kPrefix = 2;  // a flag's state bits; 0: not yet

template <int W>
__global__ void __launch_bounds__(kThreads) staircase_kernel(Params p) {
  using T = Word<W>;
  constexpr int CW = kTileBytes / W, TR = kThreads / CW;
  __shared__ T tot[TR][CW];
  __shared__ T carry[CW];
  __shared__ uint32_t ticket, epoch;
  const int tid = threadIdx.x, c = tid % CW, tr = tid / CW;
  if (tid == 0) {
    ticket = atomicAdd(&p.state[2], 1u);
    epoch = ld_acquire(&p.state[0]) & 0x3fffffffu;
  }
  __syncthreads();
  const int j = int(ticket) / p.tiles, t = int(ticket) % p.tiles;
  const int cw = p.batch / W, col = t * CW + c;
  const bool live = col < cw;
  const T* u = reinterpret_cast<const T*>(p.info);
  uint32_t* flags = p.state + kHeaderWords;
  // Chunk q of tile t publishes CW words of its aggregate, then CW of its
  // inclusive prefix, at carries + (q * tiles + t) * 2 CW.
  T* carries = reinterpret_cast<T*>(flags + ((p.tiles * p.chunks + 3) & ~3)) + t * 2 * CW + c;
  const long long chunk_words = (long long)p.tiles * 2 * CW;

  // s of this thread's rows: a quad of column indices a row, then its
  // gathers, so every row's loads are in flight together.
  const int row0 = (j * TR + tr) * kRows;
  T v[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) v[i] = T{};
  for (int d = 0; d < p.deg4; ++d) {
    int4 q[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      q[i] = live && row0 + i < p.m ? __ldg(p.cols + (long long)(row0 + i) * p.deg4 + d)
                                    : make_int4(-1, -1, -1, -1);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (q[i].x >= 0) v[i] = wxor(v[i], __ldg(u + (long long)q[i].x * cw + col));
      if (q[i].y >= 0) v[i] = wxor(v[i], __ldg(u + (long long)q[i].y * cw + col));
      if (q[i].z >= 0) v[i] = wxor(v[i], __ldg(u + (long long)q[i].z * cw + col));
      if (q[i].w >= 0) v[i] = wxor(v[i], __ldg(u + (long long)q[i].w * cw + col));
    }
  }
#pragma unroll
  for (int i = 1; i < kRows; ++i) v[i] = wxor(v[i], v[i - 1]);
  tot[tr][c] = v[kRows - 1];
  __syncthreads();
  T below{};  // the thread rows above this one in the block
  for (int q = 0; q < tr; ++q) below = wxor(below, tot[q][c]);
  T agg{};
  if (tr == 0) {
    for (int q = 0; q < TR; ++q) agg = wxor(agg, tot[q][c]);
    __stcg(carries + j * chunk_words + (j == 0 ? CW : 0), agg);  // chunk 0's aggregate is its prefix
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) st_release(flags + j * p.tiles + t, epoch << 2 | (j == 0 ? kPrefix : kAggregate));

  copy_info(p.info, p.codeword, (long long)p.k * p.batch);

  if (tr == 0) {
    T pre{};
    for (int q = j - 1; live && q >= 0;) {
      const uint32_t f = ld_acquire(flags + q * p.tiles + t);
      if ((f >> 2) != epoch || (f & 3) == 0) continue;  // chunk q has not published yet
      if (f & kPrefix) {
        pre = wxor(pre, __ldcg(carries + q * chunk_words + CW));
        break;
      }
      pre = wxor(pre, __ldcg(carries + q * chunk_words));
      --q;
    }
    carry[c] = pre;
    if (j > 0) {
      __stcg(carries + j * chunk_words + CW, wxor(pre, agg));
      __threadfence();
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (j > 0) st_release(flags + j * p.tiles + t, epoch << 2 | kPrefix);
    __threadfence();
    if (atomicAdd(&p.state[1], 1u) == gridDim.x - 1) {  // the last block: ready the next launch
      p.state[1] = 0;
      p.state[2] = 0;
      p.state[0] = (epoch + 1) & 0x3fffffffu;
    }
  }
  if (!live) return;
  const T add = wxor(carry[c], below);
  T* parity = reinterpret_cast<T*>(p.codeword) + (long long)p.k * cw;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (row0 + i < p.m) __stcs(parity + (long long)(row0 + i) * cw + col, wxor(v[i], add));
}

// The 32 bytes of info row `row` at codewords [c0, c0 + 32), zero past the
// batch: two 16-byte loads where the batch allows them (kVec), else bytes.
template <bool kVec>
__device__ __forceinline__ void info_bytes(const Params& p, int row, int c0, uint32_t (&b)[8]) {
  const uint8_t* src = p.info + (long long)row * p.batch + c0;
  if (kVec) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 hi = c0 + 16 < p.batch ? __ldg(reinterpret_cast<const uint4*>(src) + 1)
                                       : make_uint4(0, 0, 0, 0);
    b[0] = lo.x, b[1] = lo.y, b[2] = lo.z, b[3] = lo.w;
    b[4] = hi.x, b[5] = hi.y, b[6] = hi.z, b[7] = hi.w;
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      uint32_t x = 0;
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (c0 + 4 * w + y < p.batch) x |= uint32_t(__ldg(src + 4 * w + y)) << (8 * y);
      b[w] = x;
    }
  }
}

// grid: (ceil(batch / 32) groups) x (splits of the parity rows).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) dense_kernel(Params p) {
  __shared__ uint32_t sbits[kMaxDenseWords][32];  // [word][codeword]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int warps = kThreads / 32;
  const int c0 = blockIdx.x * 32, col = c0 + lane;
  if (blockIdx.y == 0) copy_info(p.info, p.codeword, (long long)p.k * p.batch);
  // s: a lane takes a check row and XORs the 32 codewords' bytes of its info
  // rows; 32 ballots turn the warp's 32 rows into a word for each codeword.
  for (int w = warp; w < p.stride; w += warps) {
    const int r = w * 32 + lane;
    uint32_t s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int d = 0; r < p.m && d < p.deg4; ++d) {
      const int4 q = __ldg(p.cols + (long long)r * p.deg4 + d);
      const int idx[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (idx[e] < 0) continue;
        uint32_t b[8];
        info_bytes<kVec>(p, idx[e], c0, b);
#pragma unroll
        for (int x = 0; x < 8; ++x) s[x] ^= b[x];
      }
    }
    uint32_t mine = 0;
#pragma unroll
    for (int cwd = 0; cwd < 32; ++cwd) {
      const uint32_t bits = __ballot_sync(0xffffffffu, (s[cwd >> 2] >> (8 * (cwd & 3))) & 1u);
      if (lane == cwd) mine = bits;
    }
    sbits[w][lane] = mine;
  }
  __syncthreads();
  if (col >= p.batch) return;
  const int per = (p.m + gridDim.y - 1) / gridDim.y;
  const int r0 = blockIdx.y * per, r1 = min(p.m, r0 + per);
  uint8_t* parity = p.codeword + (long long)p.k * p.batch;
  for (int i = r0 + warp; i < r1; i += warps) {
    const uint4* row = reinterpret_cast<const uint4*>(p.binv + (long long)i * p.stride);
    uint32_t acc = 0;
    for (int w4 = 0; w4 < p.stride / 4; ++w4) {
      const uint4 b = __ldg(row + w4);
      acc ^= (b.x & sbits[4 * w4][lane]) ^ (b.y & sbits[4 * w4 + 1][lane]) ^
             (b.z & sbits[4 * w4 + 2][lane]) ^ (b.w & sbits[4 * w4 + 3][lane]);
    }
    __stcs(parity + (long long)i * p.batch + col, uint8_t(__popc(acc) & 1));
  }
}

int tiles_of(int batch) { return (batch + kTileBytes - 1) / kTileBytes; }
int chunks_of(int m, int word_bytes) {
  const int rows = kThreads / (kTileBytes / word_bytes) * kRows;
  return (m + rows - 1) / rows;
}

}  // namespace

extern "C" {

// 32-bit words of the staircase path's state buffer for m checks, a batch and
// a word width; the buffer starts zeroed and is reused across launches of
// that shape only.
int encoder_state_words(int m, int batch, int word_bytes) {
  const int blocks = tiles_of(batch) * chunks_of(m, word_bytes);
  return kHeaderWords + (blocks + 3) / 4 * 4 + blocks * 2 * kTileBytes / 4;
}

// Staircase B: the codeword [k + m, batch] of the info plane [k, batch] on
// `stream`, in words of `word_bytes` (16 or 1) codeword columns, which must
// divide the batch and align both planes. `cols` holds each check's info
// columns in `deg4` quads, padded with -1 (both paths).
int encoder_staircase(const void* info, void* codeword, const void* cols, int deg4, void* state,
                      int k, int m, int batch, int word_bytes, void* stream) {
  if (!info || !codeword || !cols || deg4 < 1 || !state || k < 1 || m < 1 || batch < 1 ||
      (word_bytes != 16 && word_bytes != 1) || batch % word_bytes ||
      (reinterpret_cast<uintptr_t>(info) | reinterpret_cast<uintptr_t>(codeword)) % word_bytes ||
      reinterpret_cast<uintptr_t>(cols) % 16)
    return int(cudaErrorInvalidValue);
  Params p{static_cast<const uint8_t*>(info), static_cast<uint8_t*>(codeword),
           static_cast<const int4*>(cols), nullptr, static_cast<uint32_t*>(state), k, m, batch,
           deg4, 0, tiles_of(batch), chunks_of(m, word_bytes)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = unsigned(p.tiles * p.chunks);
  if (word_bytes == 16) staircase_kernel<16><<<blocks, kThreads, 0, st>>>(p);
  else staircase_kernel<1><<<blocks, kThreads, 0, st>>>(p);
  return int(cudaGetLastError());
}

// Dense B^-1: the codeword of the info plane with B^-1's rows packed [m,
// stride] (stride a multiple of 4 words, at least ceil(m / 32)), the rows
// split over `splits` blocks a group of 32 codewords; 16-byte loads of the
// info where the batch is a multiple of 16.
int encoder_dense(const void* info, void* codeword, const void* cols, int deg4, const void* binv,
                  int k, int m, int batch, int stride, int splits, void* stream) {
  if (!info || !codeword || !cols || deg4 < 1 || !binv || k < 1 || m < 1 ||
      m > kMaxDenseChecks || batch < 1 || stride % 4 || stride * 32 < m ||
      stride > kMaxDenseWords || splits < 1 || splits > m ||
      (reinterpret_cast<uintptr_t>(cols) | reinterpret_cast<uintptr_t>(binv)) % 16)
    return int(cudaErrorInvalidValue);
  Params p{static_cast<const uint8_t*>(info), static_cast<uint8_t*>(codeword),
           static_cast<const int4*>(cols), static_cast<const uint32_t*>(binv), nullptr, k, m, batch,
           deg4, stride, 0, 0};
  const dim3 grid(unsigned((batch + 31) / 32), unsigned(splits));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch % 16 == 0 && reinterpret_cast<uintptr_t>(info) % 16 == 0)
    dense_kernel<true><<<grid, kThreads, 0, st>>>(p);
  else
    dense_kernel<false><<<grid, kThreads, 0, st>>>(p);
  return int(cudaGetLastError());
}

int encoder_max_dense_checks() { return kMaxDenseChecks; }

const char* encoder_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
