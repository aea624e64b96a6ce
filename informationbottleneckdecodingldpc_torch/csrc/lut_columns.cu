// P1: packed-LUT column builds on CUDA cores against tensor cores, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU probe of the JAX reference's
// scripts/mxu_col_probe.py: vpu_variant (compare-select column builds on the
// vector unit) and mxu_variant (the same columns as a one-hot f32 matmul on
// the matrix unit). Both run the same chain per element, `loops` steps:
//
//   cols[k] = packed[k][b]                (k < W: the column of the packed LUT)
//   e       = extract(cols, b & (T1-1), fb)   (ops/lut_fold.py _extract)
//   b       = (e + b) & (T1-1);  acc += cols[0]
//
// and write acc + b (wrapping int32). Two configurations: T1 = 16 with 4-bit
// fields in W = 2 words, and T1 = 32 with split packing (fb = 5: four words
// of low nibbles and one word of high bits, W = 5). Every step builds all W
// words of column b, from shared memory or from the mma, and the extract runs
// on them. The constant operands (the shared-memory table, the mma's byte
// matrix as B fragments) are laid out by kernels/lut_columns.py, where the
// CPU tests hold them; the kernels copy them as they are.
//
// Bound: per element-step, the column's W words of shared memory at 32 a
// clock per SM (CUDA cores; the issue limit counts its 2 load instructions)
// or the one-hot mma's int8 operations on the column's 4W bytes (tensor
// cores), and the extract's and the update's integer work
// (utils/roofline.py COLUMN_STEP_OPS) against its pipes and the issue
// limit. On this card the tensor-core variant is held
// by what surrounds its mma: gathering the b's, building the A fragments
// and assembling words from accumulator bytes, 41 instructions an
// element-step at T1 = 16 and 76 at 32 as nvcc builds it for sm_90a, most
// on the integer ALU pipe, where the CUDA cores' loop takes 17.
//
// cuda_cores: the table lies in shared memory. T1 = 16 keeps the layout
// [W][T1], W 32-bit loads a step, each lane's word of a row in its own bank
// (conflict-free). T1 = 32 reads a column with two loads: a 128-bit load of
// its four nibble words and a 32-bit load of its high-bit word. The nibble
// words lie as eight copies of [T1][4], copy c in bank group c, and lane l
// reads copy l % 8, so the eight lanes of each quarter-warp phase of the
// 128-bit load hit eight different bank groups whatever their b: 5
// wavefronts a step in 2 instructions instead of 5. Its extract selects the
// nibble word by three predicated selects (select4): as a chain of selects
// nvcc branched per select, and lanes whose b differ ran the branches one
// after the other. Each thread runs kPer independent elements.
//
// tensor_cores: one-hot(b) [16 elements, T1] times the byte matrix [T1, 8 NT]
// on mma.sync.m16n8k16 (T1 = 16) or m16n8k32 (T1 = 32) u8 x u8 -> s32: a
// byte and a single 1 per row are exact in s32, and no accumulator is
// converted. The byte matrix's columns are permuted (and padded: NT n-tiles)
// so that the bytes a lane holds assemble into whole words (lut_columns.py
// COLUMN_BYTES). A warp runs kPairs pairs of 16-element tiles. Within a
// pair, the lane with group g = lane / 4 and q = lane % 4 owns one element:
// row g + 8 (q & 1) of tile q >> 1, so the pair's 32 elements are one per
// lane and each runs its extract once. After the mma a lane holds two bytes
// (columns 2q, 2q + 1) of the n-tile for each of the 4 elements of its
// group; two exchanges (lane ^ 2 across the tile bit, lane ^ 1 across the
// row bit), each one __shfl_xor_sync of a word packed by __byte_perm with
// selectors that depend on the lane, leave it two whole words of its own
// element: word 2 nt + (q & 1) and its neighbour. T1 = 32's word 4 sits
// twice in the third n-tile, so one exchange with lane ^ 1 completes it. A
// lane's words are in the order [q & 1, 1 - (q & 1), ...], which the extract
// takes by flipping the word index. The A fragment of a row is, per
// register, 1 << (8 b - 32 kq) with PTX's clamped shift (0 unless b lies in
// the register's four k): every lane of a group reads the group's four b
// with __shfl_sync, as all four rows' fragments need them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;     // elements per thread (cuda_cores)
constexpr int kPairs = 2;   // tile pairs per warp (tensor_cores)
constexpr unsigned kFull = 0xffffffffu;

// Word (j >> 3) & 3 of c0..c3 by three predicated selects. Written as a
// chain of selects over the words, nvcc indexes them as an array and
// branches per select, and lanes whose b differ then run the branches one
// after the other.
__device__ __forceinline__ uint32_t select4(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                            int j) {
  uint32_t r;
  asm("{\n\t.reg .pred p, q;\n\t.reg .b32 wlo, whi;\n\t"
      "setp.ne.u32 p, %5, 0;\n\tsetp.ne.u32 q, %6, 0;\n\t"
      "selp.b32 wlo, %3, %1, p;\n\tselp.b32 whi, %4, %2, p;\n\tselp.b32 %0, whi, wlo, q;\n\t}"
      : "=r"(r)
      : "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(j & 16), "r"(j & 8));
  return r;
}

// Field `a` of the packed column (ops/lut_fold.py _extract): the word that
// `wa` selects and the field of `a` in it; fb = 5 is split packing, the low
// nibble from words 0..W-2 and the high bit from word W-1. `wa` is `a` with
// the word index's low bit flipped where the words come in that order.
template <int FB, int W>
__device__ __forceinline__ uint32_t extract(const uint32_t (&cols)[W], int a, int wa) {
  if constexpr (FB == 5) {
    static_assert(W == 5, "split packing: four nibble words and the high-bit word");
    const uint32_t word = select4(cols[0], cols[1], cols[2], cols[3], wa);
    return ((word >> (4 * (a & 7))) & 15u) | (((cols[W - 1] >> (a & 31)) & 1u) << 4);
  } else {
    constexpr int kPerWord = 32 / FB;
    constexpr int kShift = kPerWord == 8 ? 3 : kPerWord == 4 ? 2 : kPerWord == 16 ? 4 : 5;
    uint32_t word = cols[0];
#pragma unroll
    for (int k = 1; k < W; ++k) word = (wa >> kShift) == k ? cols[k] : word;
    return (word >> (FB * (a & (kPerWord - 1)))) & ((1u << FB) - 1u);
  }
}

// Words of the CUDA-core table (kernels/lut_columns.py cuda_table): [W][T1]
// at T1 = 16; eight copies of [T1][4] nibble words and then [T1] high-bit
// words at T1 = 32.
template <int T1, int W>
__host__ __device__ constexpr int table_words() {
  return T1 == 32 ? 8 * T1 * 4 + T1 : W * T1;
}

template <int T1, int FB, int W>
__global__ void __launch_bounds__(kThreads)
    cuda_cores_kernel(const uint32_t* table, const int32_t* b0, int32_t* out, int loops) {
  constexpr int kWords = table_words<T1, W>();
  __shared__ __align__(16) uint32_t tab[kWords];
  for (int i = threadIdx.x; i < kWords; i += kThreads) tab[i] = table[i];
  __syncthreads();
  const int base = blockIdx.x * kThreads * kPer + threadIdx.x;
  const uint4* copy = reinterpret_cast<const uint4*>(tab) + (threadIdx.x & 7);
  uint32_t b[kPer], acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    b[c] = uint32_t(b0[base + c * kThreads]) & (T1 - 1);
    acc[c] = 0;
  }
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      uint32_t cols[W];
      if constexpr (T1 == 32) {
        const uint4 nib = copy[b[c] * 8];
        cols[0] = nib.x, cols[1] = nib.y, cols[2] = nib.z, cols[3] = nib.w;
        cols[4] = tab[8 * T1 * 4 + b[c]];
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) cols[k] = tab[k * T1 + b[c]];
      }
      const int a = int(b[c]) & (T1 - 1);
      const uint32_t e = extract<FB, W>(cols, a, a);
      acc[c] += cols[0];
      b[c] = (e + b[c]) & (T1 - 1);
    }
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) out[base + c * kThreads] = int32_t(acc[c] + b[c]);
}

// 1 << s, 0 for s >= 32 (and so for a negative s): PTX clamps the amount.
__device__ __forceinline__ uint32_t shl1(int s) {
  uint32_t r;
  asm("shl.b32 %0, 1, %1;" : "=r"(r) : "r"(s));
  return r;
}

template <int T1>
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[T1 / 8],
                                       const uint32_t (&b)[T1 / 16]) {
  d[0] = d[1] = d[2] = d[3] = 0;
  if constexpr (T1 == 16) {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// n-tiles of the byte matrix: T1 = 16 one (8 bytes); T1 = 32 two for the
// four nibble words and a third with word 4 twice.
template <int T1>
__host__ __device__ constexpr int n_tiles() {
  return T1 == 16 ? 1 : 3;
}

template <int T1, int FB, int W>
__global__ void __launch_bounds__(kThreads)
    tensor_cores_kernel(const uint32_t* frags, const int32_t* b0, int32_t* out, int loops) {
  constexpr int KR = T1 / 16;       // B registers per n-tile; A registers per row
  constexpr int NT = n_tiles<T1>();
  constexpr int NX = 2 * (W / 2);   // words assembled by the two exchanges
  const int lane = threadIdx.x & 31, q = lane & 3, group = lane & ~3;
  const int q0 = q & 1, q1 = q >> 1;
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int mine = warp * kPairs * 32 + 16 * q1 + (lane >> 2) + 8 * q0;

  // B fragments, lane-major (lut_columns.py b_fragments), fixed for the chain.
  uint32_t bf[NT][KR];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int r = 0; r < KR; ++r) bf[nt][r] = frags[(nt * KR + r) * 32 + lane];
  }
  // __byte_perm selectors. tile: byte 0 from this lane's tile (q1), byte 1
  // from the other. row: the same for this lane's row (q0). keep / send: the
  // lane's row and the other row of the words of the lane ^ 2 exchange,
  // pieces with bit 1 clear in the low half. word4: this lane's half of word
  // 4 at bytes 2 q0, the partner's at the others.
  const uint32_t tile = q1 ? 0x0004u : 0x0040u, row = q0 ? 0x0004u : 0x0040u;
  const uint32_t keep = q1 ? (q0 ? 0x3276u : 0x1054u) : (q0 ? 0x7632u : 0x5410u);
  const uint32_t send = q1 ? (q0 ? 0x1054u : 0x3276u) : (q0 ? 0x5410u : 0x7632u);
  const uint32_t word4 = q0 ? 0x1076u : 0x7610u;

  uint32_t b[kPairs], acc[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    b[p] = uint32_t(b0[mine + 32 * p]) & (T1 - 1);
    acc[p] = 0;
  }
#pragma unroll 1
  for (int l = 0; l < loops; ++l) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      // A fragments of the group's elements: element 2 t + h is lane group + 2 t + h.
      uint32_t a[2][T1 / 8];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = 8 * int(__shfl_sync(kFull, b[p], group + 2 * t + h)) - 32 * q;
#pragma unroll
          for (int r = 0; r < KR; ++r) a[t][2 * r + h] = shl1(s - 128 * r);
        }
      }
      uint32_t c[2][NT][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_u8<T1>(c[t][nt], a[t], bf[nt]);
      }
      // cols in the lane's order: [word q0, word 1 - q0, word 2 + q0, word 3 - q0, word 4].
      uint32_t cols[W];
#pragma unroll
      for (int x = 0; x < NX / 2; ++x) {
        uint32_t u[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t m0 = __byte_perm(c[0][x][2 * h], c[1][x][2 * h], tile);
          const uint32_t m1 = __byte_perm(c[0][x][2 * h + 1], c[1][x][2 * h + 1], tile);
          u[h] = __byte_perm(m0, m1, 0x5140u);  // [this tile j0, j1, other tile j0, j1]
        }
        const uint32_t kept = __byte_perm(u[0], u[1], 0x5410u);
        const uint32_t got = __shfl_xor_sync(kFull, __byte_perm(u[0], u[1], 0x7632u), 2);
        cols[2 * x] = __byte_perm(kept, got, keep);
        cols[2 * x + 1] = __shfl_xor_sync(kFull, __byte_perm(kept, got, send), 1);
      }
      if constexpr (W > NX) {
        uint32_t v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t y = __byte_perm(c[0][NT - 1][j], c[1][NT - 1][j], tile);
          const uint32_t z = __byte_perm(c[0][NT - 1][2 + j], c[1][NT - 1][2 + j], tile);
          v[j] = __byte_perm(y, z, row);
        }
        const uint32_t u = __byte_perm(v[0], v[1], 0x5140u);  // [this row j0, j1, other row j0, j1]
        cols[W - 1] = __byte_perm(u, __shfl_xor_sync(kFull, u, 1), word4);
      }
      const int a_ = int(b[p]);
      const uint32_t e = extract<FB, W>(cols, a_, a_ ^ (q0 << 3));
      acc[p] += q0 ? cols[1] : cols[0];
      b[p] = (e + b[p]) & (T1 - 1);
    }
  }
#pragma unroll
  for (int p = 0; p < kPairs; ++p) out[mine + 32 * p] = int32_t(acc[p] + b[p]);
}

enum Variant { kCudaCores = 0, kTensorCores = 1 };

const void* kernel_of(int variant, int t1) {
  if (variant == kCudaCores) {
    if (t1 == 16) return reinterpret_cast<const void*>(cuda_cores_kernel<16, 4, 2>);
    if (t1 == 32) return reinterpret_cast<const void*>(cuda_cores_kernel<32, 5, 5>);
  } else if (variant == kTensorCores) {
    if (t1 == 16) return reinterpret_cast<const void*>(tensor_cores_kernel<16, 4, 2>);
    if (t1 == 32) return reinterpret_cast<const void*>(tensor_cores_kernel<32, 5, 5>);
  }
  return nullptr;
}

int block_elements(int variant) {
  return variant == kCudaCores ? kThreads * kPer : (kThreads / 32) * kPairs * 32;
}

}  // namespace

extern "C" {

int lut_columns_block_elements(int variant) { return block_elements(variant); }

// Elements of a launch of `variant` at T1 = `t1` that fills every SM: the SM
// count times the blocks one SM holds at once times a block's elements.
int lut_columns_elements_to_fill(int variant, int t1, int* elements) {
  const void* kernel = kernel_of(variant, t1);
  if (kernel == nullptr) return int(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return int(err);
  *elements = sms * per_sm * block_elements(variant);
  return 0;
}

// The chain of `variant` (0: cuda_cores, 1: tensor_cores) at T1 = `t1` (16:
// fb 4, W 2; 32: fb 5, W 5) over `elements` int32 elements of `b0` (a
// multiple of the block's elements), `loops` steps: `operand` the variant's
// constant operand as kernels/lut_columns.py lays it out (the CUDA-core
// table or the tensor cores' B fragments), `out` [elements] int32.
int lut_columns_chain(int variant, int t1, const uint32_t* operand, const int32_t* b0, int32_t* out,
                      int elements, int loops, void* stream) {
  const void* kernel = kernel_of(variant, t1);
  const int per_block = block_elements(variant);
  if (kernel == nullptr || elements <= 0 || elements % per_block) return int(cudaErrorInvalidValue);
  void* args[] = {&operand, &b0, &out, &loops};
  return int(cudaLaunchKernel(kernel, dim3(elements / per_block), dim3(kThreads), args, 0,
                              static_cast<cudaStream_t>(stream)));
}

const char* lut_columns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
