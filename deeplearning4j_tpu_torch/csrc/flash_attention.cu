// Flash attention for Hopper (sm_90a): the forward (K1) and the two halves
// of the FlashAttention-2 backward, dq (K2) and dk/dv (K3).
//
// Replaces, in deeplearning4j_tpu/ops/pallas_attention.py:
//   _fwd_kernel     (launched by _flash_fwd_impl)  -> flash_fwd_kernel
//   _bwd_dq_kernel  (launched by _flash_bwd_impl)  -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (launched by _flash_bwd_impl)  -> flash_bwd_dkv_kernel
// and computes what they compute: scores q.k^T * (1/sqrt(D)) in fp32, the
// mask k_pos < Tk (and q_pos >= k_pos when causal, positions counted from 0
// on both axes), the finite -1e30 mask value with probabilities of masked
// keys zeroed explicitly, an exact zero output row and the +1e30 lse
// sentinel where a row has no valid key. The backward rebuilds
// p = exp(s - lse) from the saved per-row logsumexp; delta = rowsum(do*o)
// arrives precomputed (ops/flash_attention.py, one torch op).
//
// Layouts: q [B, H, Tq, D], k/v [B, H, Tk, D] with any batch, head and row
// strides (in elements, passed by value) and a unit stride along D; the
// callers' [B, T, H, D] -> [B, H, T, D] transposes therefore cost no copy.
// Outputs are contiguous: o and dq [B, H, Tq, D], dk and dv [B, H, Tk, D],
// lse and delta [B*H, Tq] fp32. Inputs and outputs are fp32 or bf16; every
// product is taken in 3xTF32 on the tensor cores (as accurate as fp32),
// every sum in fp32, and each output is rounded once to the input type. D
// is any multiple of 8 up to 128: the tiles are padded with zeros to DP in
// {16, 32, 64, 128}, which adds exact zeros to every dot product.
//
// What bounds them on the H100: operations. At the training shapes (B 8,
// H 12, T 512, D 64) K1 does 4*B*H*T^2*D = 6.4 GFLOP on 50 MB of q/k/v/o
// (~128 flop per byte), K2 1.5x and K3 2x K1's flops; the bytes take
// 0.015 ms at 3.35 TB/s. For f32 work the card's fastest fp32-accurate
// route is 3xTF32 on the tensor cores: 495/3 = 165 TFLOP/s, against 67 on
// the CUDA cores.
//
// All three run every product on the tensor cores in 3xTF32 (mma.sync
// m16n8k8, fp32 accumulators; the comment that opens the tensor-core
// section says how), a warp per 16 rows of the block's own 64 or 128: q
// rows in K1 and K2, keys in K3. The scores, probabilities and dS never
// leave registers: a C fragment is the A operand of the next product (K1:
// P of P.V; K2: dS of dS.K; K3: P^T and dS^T). The streamed operand, K/V
// (K1, K2) or q/do (K3), comes in tiles of 32 rows through a two-stage
// ring of 16-byte cp.async copies into XOR-swizzled tiles, the next tile
// loading while this one is multiplied, and each tile is split into its
// TF32 parts once per block. K1's online softmax runs on the C fragments:
// a row's max and sum are taken over the four lanes that hold it, and acc
// is rescaled once per tile. What bounds the kernels is the instruction
// rate and latency, not the tensor cores: a product takes three MMAs, the
// splits and the per-k-step fp32 adds, and a warp has few independent ones
// in flight. bf16 values are TF32 values, so in bf16 K1 leaves out the
// products with a small part that is zero by construction.
//
// Causal tiles wholly above the diagonal are skipped (K1, K2: the KV loop
// ends at the last tile the q tile can see, and in K1 a warp whose 16 rows
// see none of a tile's keys skips its math; K3: the q loop starts at the
// diagonal), as the reference skips its blocks; K1's causal grid starts
// the q tiles with the most keys first. The TPU kernels hold the whole K/V
// (or q/do) of a head in VMEM and loop with fori_loop; here a block stages
// one tile at a time, and blocks run in no order, so a block owns its
// output tile outright: o belongs to K1, dq to K2, dk/dv to K3, no kernel
// uses atomics, and every sum has one fixed order, so two runs on the same
// inputs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr float kLseEmpty = 1e30f;  // lse of a row with no valid key
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of one [B, H, T, D] operand (D stride 1)
  long long b, h, t;
};
struct Layout {   // q, k, v, and do (backward) or unused (forward)
  Strides q, k, v, g;
};

// ---------------------------------------------------------------------------
// The products of K1-K3 on the tensor cores, fp32-accurate.
//
// mma.sync.m16n8k8 with tf32 operands and fp32 accumulators. Each fp32
// operand x is split into big = tf32(x) and small = tf32(x - big) (both
// rounded to nearest, ties away, as cvt.rna does), and a.b is taken as
// small(a).big(b) + big(a).small(b), then + big(a).big(b): the split and
// order of CUTLASS's OpMultiplyAddFastF32, the operator PyTorch's
// memory-efficient attention uses for f32. Each k-step's three products go
// into a zeroed fragment that is added to the accumulator in fp32 (mma3
// says why). Only small.small (~2^-22 of a.b) is dropped; one TF32 pass
// would keep ~2^-11 and is not used.
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A 16x8:  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B 8x8:   b0 (k t, n g)  b1 (k t+4, n g)
//   C 16x8:  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A C fragment feeds the next product as its A operand without a trip
// through shared memory once the 8 keys of that k-step are taken in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (A column t is key 2t, column t+4 key 2t+1)
// and the B fragment is loaded in the same order (b0 from row 2t, b1 from
// row 2t+1).
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the value cvt.rna.tf32.f32 gives for every finite x, in two
// integer instructions, where ptxas expands the cvt into four with a NaN
// guard (same bits, and the backward 20 % faster on the H100)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big + small == x to ~2^-22 relative
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: small.big + big.small, then big.big, into a zeroed
// fragment, which is then added to d in fp32. The tensor cores truncate
// as they accumulate: chained into d itself (24 MMAs for a D-64 dot), the
// truncations drift by many ulps of d, enough to fail the smoke's f64
// gate where dP - delta cancels; one fragment per k-step truncates only at
// the size of its 8 products, and d's sum rounds to nearest. kSmallA
// (kSmallB) false: a's (b's) small parts are zero by construction (a bf16
// value is a TF32 value), and the product that takes them is left out.
template <bool kSmallA = true, bool kSmallB = true>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  if (kSmallA) mma_tf32(t, a.small, b.big);
  if (kSmallB) mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// The A operand of the next product from a C fragment (keys permuted as
// above)
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16-byte copy; bytes == 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tiles of T in shared memory, [rows][DP] in the input type: each row is
// DP / kCh chunks of 16 bytes (whole chunks for cp.async, whose
// destination must be 16-byte aligned, which a DP + 1 row pitch breaks),
// and the chunks of row r are permuted by an XOR: element (r, d) lies at
// r * DP + ((d & ~7) ^ x(r)) + (d & 7), x(r) a multiple of 8. The
// fragment loads read a tile along its rows (8 rows x 8 columns a step,
// 8 bytes a lane) and along its columns (4 row pairs x 8 columns, 4 bytes
// a lane). No fixed row padding serves both; the XOR puts each load's
// lanes on distinct banks (DP >= 32 in f32, >= 64 in bf16): f32 rows r =
// (b2 b1 b0) take x = 8 * ((b1 ^ b0) << 1 | (b2 ^ b1)), which differs
// across rows 0-3, rows 4-7, the even and the odd rows, as the two loads
// need; bf16 rows take 8 * (r & 7). A lane's address for the k-step at
// column c0 is then its own base plus (c0 ^ its own x), one XOR shared by
// every row block of the step.
template <typename T, int DP>
struct Swz {
  static constexpr int kCh = 16 / (int)sizeof(T);
  static constexpr int kNc = DP / kCh;
  static constexpr int kMask = (kNc < 8 ? kNc : 8) - 1;  // chunk bits
  static __device__ __forceinline__ int x(int r) {
    const int b = r & 7;
    const int w = (((b >> 1) ^ b) & 1) << 2 | (((b >> 2) ^ (b >> 1)) & 1) << 1;
    return ((sizeof(T) == 4 ? w : b) & kMask) * kCh;
  }
  static __device__ __forceinline__ int at(int r, int d) {
    return r * DP + ((d & ~7) ^ x(r)) + (d & 7);
  }
};

// Two neighbouring values (d even) of a tile as fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A lane's offsets into a swizzled tile: the row load reads row g,
// columns 2t and 2t+1; the column load rows 2t + e, column g (rows
// counted from a multiple of 8, so their XOR is the lane's own)
template <typename T, int DP>
struct Lanes {
  int row, xrow, col[2], xcol[2];
  __device__ __forceinline__ Lanes() {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    row = g * DP + 2 * t;
    xrow = Swz<T, DP>::x(g);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      col[e] = (2 * t + e) * DP + g;
      xcol[e] = Swz<T, DP>::x(2 * t + e);
    }
  }
};

// Start the copies of ROWS rows from row0 of one head (base `src`, row
// stride `rs` elements) into the swizzled tile `dst`; rows at or past `n`
// and columns at or past D are zero-filled (D is a multiple of 8, so a
// chunk is wholly in or out). The trip count is known at compile time, so
// the loop unrolls and a thread's offsets are the same on every call.
template <typename T, int DP, int THREADS, int ROWS>
__device__ __forceinline__ void stage_async(T* dst, const T* src,
                                            long long rs, int row0, int n,
                                            int D) {
  constexpr int kCh = Swz<T, DP>::kCh, kNc = Swz<T, DP>::kNc;
  constexpr int kChunks = ROWS * kNc;
#pragma unroll
  for (int i0 = 0; i0 < kChunks; i0 += THREADS) {
    const int i = i0 + (int)threadIdx.x;
    if (kChunks % THREADS != 0 && i >= kChunks) break;
    const int r = i / kNc, d = (i - r * kNc) * kCh;
    const bool in = row0 + r < n && d < D;
    cp_async16(dst + Swz<T, DP>::at(r, d),
               in ? src + (long long)(row0 + r) * rs + d : src, in ? 16 : 0);
  }
}

// The products over D (S and dP) take the 8 columns of a k-step in the
// order 0, 2, 4, 6, 1, 3, 5, 7 on both operands (A column t and B row t
// are column 2t, A column t+4 and B row t+4 column 2t+1), so a lane's two
// values of a row are neighbours and arrive in one load.

// Rows of a streamed tile: K/V (K1, K2) or q/do (K3), 4 blocks of 8 (16 rows
// measured slower on the H100: more barriers and A-operand splits for the
// same work)
constexpr int kStream = 32;
constexpr int kNB = kStream / 8;

// A operand: rows r0 .. r0+15, columns c0 .. c0+7 of a tile in the input
// type, times mul, split as it is loaded
template <typename T, int DP>
__device__ __forceinline__ void load_a(FragA& f, const T* tile,
                                       const Lanes<T, DP>& ln, int r0,
                                       int c0, float mul = 1.f) {
  const T* p = tile + r0 * DP + ln.row + (c0 ^ ln.xrow);
  const float2 x = ld2(p), y = ld2(p + 8 * DP);
  split(x.x * mul, f.big[0], f.small[0]);
  split(y.x * mul, f.big[1], f.small[1]);
  split(x.y * mul, f.big[2], f.small[2]);
  split(y.y * mul, f.big[3], f.small[3]);
}

// A streamed tile split once per block: the big and small TF32 parts of
// each value as fp32 bit patterns, [kStream][DP] each, in the f32 layout.
// Every warp reads every value of the tile (and K2's K and K3's q/do
// twice, along rows and along columns), so splitting it on the way into
// registers would repeat each split 4-8 times.
struct SplitTile {
  uint32_t* big;
  uint32_t* small;
};

// Split the raw tile `raw` (kStream rows, cp.async layout) into `dst`,
// four values a thread and step
template <typename T, int DP, int THREADS>
__device__ __forceinline__ void split_tile(SplitTile dst, const T* raw) {
  constexpr int kQuads = kStream * DP / 4;
#pragma unroll
  for (int i0 = 0; i0 < kQuads; i0 += THREADS) {
    const int i = i0 + (int)threadIdx.x;
    if (kQuads % THREADS != 0 && i >= kQuads) break;
    const int r = i / (DP / 4), d = (i - r * (DP / 4)) * 4;
    float v[4];
    if constexpr (sizeof(T) == 4) {
      const float4 u =
          *reinterpret_cast<const float4*>(raw + Swz<T, DP>::at(r, d));
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const float2 a = ld2(raw + Swz<T, DP>::at(r, d));
      const float2 b = ld2(raw + Swz<T, DP>::at(r, d) + 2);
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    }
    uint4 hi, lo;
    split(v[0], hi.x, lo.x);
    split(v[1], hi.y, lo.y);
    split(v[2], hi.z, lo.z);
    split(v[3], hi.w, lo.w);
    const int at = Swz<float, DP>::at(r, d);
    *reinterpret_cast<uint4*>(dst.big + at) = hi;
    *reinterpret_cast<uint4*>(dst.small + at) = lo;
  }
}

// B operand of X.tile^T from a split tile: k = columns c0 .. c0+7, n =
// rows n0 .. n0+7
template <int DP>
__device__ __forceinline__ void load_b_rows(FragB& f, SplitTile tile,
                                            const Lanes<float, DP>& ln,
                                            int n0, int c0) {
  const int at = n0 * DP + ln.row + (c0 ^ ln.xrow);
  const uint2 hi = *reinterpret_cast<const uint2*>(tile.big + at);
  const uint2 lo = *reinterpret_cast<const uint2*>(tile.small + at);
  f.big[0] = hi.x, f.big[1] = hi.y, f.small[0] = lo.x, f.small[1] = lo.y;
}

// B operand of C.tile from a split tile: k = rows k0 .. k0+7 in the C
// fragment's order (b0 row 2t, b1 row 2t+1), n = columns c0 .. c0+7
template <int DP>
__device__ __forceinline__ void load_b_cols(FragB& f, SplitTile tile,
                                            const Lanes<float, DP>& ln,
                                            int k0, int c0) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int at = k0 * DP + ln.col[e] + (c0 ^ ln.xcol[e]);
    f.big[e] = tile.big[at];
    f.small[e] = tile.small[at];
  }
}

// Store a C fragment, times mul, to a contiguous [n, D] output: this
// lane's rows `row` and row + 8, columns col and col + 1; rows at or past
// n are skipped.
template <typename T>
__device__ __forceinline__ void store_c(T* out, const float (&c)[4], int row,
                                        int n, int D, int col, float mul);
template <>
__device__ __forceinline__ void store_c<float>(float* out,
                                               const float (&c)[4], int row,
                                               int n, int D, int col,
                                               float mul) {
  if (row < n)
    *reinterpret_cast<float2*>(out + (long long)row * D + col) =
        make_float2(c[0] * mul, c[1] * mul);
  if (row + 8 < n)
    *reinterpret_cast<float2*>(out + (long long)(row + 8) * D + col) =
        make_float2(c[2] * mul, c[3] * mul);
}
template <>
__device__ __forceinline__ void store_c<__nv_bfloat16>(
    __nv_bfloat16* out, const float (&c)[4], int row, int n, int D, int col,
    float mul) {
  if (row < n)
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D + col) =
        __floats2bfloat162_rn(c[0] * mul, c[1] * mul);
  if (row + 8 < n)
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row + 8) * D + col) =
        __floats2bfloat162_rn(c[2] * mul, c[3] * mul);
}

// Max and sum over the four lanes of a quad, which hold the same two rows
// of a C fragment. Butterflies: every lane ends with the same bits.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The block shape of K1 for input type T at padded width DP: kRows query
// rows, a warp per 16 of them. Up to DP 64, 128 rows, one block of 8
// warps an SM, in f32 and bf16 alike (measured faster than 64-row blocks
// two to an SM, which give the train shape the same 2.9 waves); DP 128: 64
// rows. Shared memory: q [kRows][DP] and the two-stage K/V ring
// [2][2][32][DP] in the input type, the split K and V [4][32][DP] 32-bit.
template <typename T, int DP>
struct Fwd {
  static constexpr int kRows = DP <= 64 ? 128 : 64;
  static constexpr int kThreads = 2 * kRows;
  static constexpr size_t kSmem =
      ((size_t)kRows + 4 * kStream) * DP * sizeof(T)
      + 4 * (size_t)kStream * DP * 4;
  static constexpr int kFit = (int)(228 * 1024 / (kSmem + 1024));
  static constexpr int kBlocks =
      kRows == 128 || kFit < 1 ? 1 : kFit > 3 ? 3 : kFit;
};

// K1. One block per (b*h, tile of kRows query rows); warp w owns rows
// 16w .. 16w+15, a lane rows g and g+8 of them. q is staged once, and a
// warp loads and splits its q fragments, times scale, at each k-step
// (measured on the H100: held in registers for the whole KV loop, they
// cost 64 registers at DP 64, spilled and gained nothing; split once into
// shared memory, they were 3 % slower). K and V tiles of 32 keys stream through the two-stage cp.async ring,
// the next tile loading during this one's math, and are split once into
// big/small tiles. Per tile: S = (q*scale).K^T into C fragments; the mask
// and the online softmax on the fragments (m, l and acc in fp32, the row
// max and sum over the quad, acc rescaled once); P, still in registers,
// is the A operand of acc += P.V. At the end o = acc / l and lse = m +
// log(l). In bf16, q, K and V are TF32 values: S takes one MMA a k-step
// and P.V two, and q is not scaled before the product (that would make
// it inexact): S is.
template <typename T, int DP>
__global__ void __launch_bounds__(Fwd<T, DP>::kThreads, Fwd<T, DP>::kBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Layout L, int H, int Tq, int Tk,
                 int D, int causal, float scale) {
  constexpr int kRows = Fwd<T, DP>::kRows;
  constexpr int kThreads = Fwd<T, DP>::kThreads;
  constexpr int kOwn = kRows * DP, kTile = kStream * DP;
  constexpr bool kExact = sizeof(T) == 2;  // small parts of q, K, V are 0
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // q [kRows][DP]
  T* ring = qs + kOwn;                     // [2][K, V][32][DP]
  uint32_t* sp = reinterpret_cast<uint32_t*>(ring + 4 * kTile);
  const SplitTile kt_s{sp, sp + kTile}, vt_s{sp + 2 * kTile, sp + 3 * kTile};
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // causal: the q tiles with the most KV tiles to walk start first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tg = lane & 3;
  const int w0 = q0 + (threadIdx.x >> 5) * 16;  // the warp's first row
  const int r0 = w0 - q0;
  const Lanes<T, DP> ln;
  const Lanes<float, DP> lf;
  const T* kh = k + b * L.k.b + h * L.k.h;
  const T* vh = v + b * L.v.b + h * L.v.h;
  stage_async<T, DP, kThreads, kRows>(qs, q + b * L.q.b + h * L.q.h, L.q.t,
                                      q0, Tq, D);
  cp_async_commit();
  const int nk = (Tk + kStream - 1) / kStream;
  const int n_used =
      causal ? min((q0 + kRows - 1) / kStream + 1, nk) : nk;
  auto fetch = [&](int i) {  // K and V of tile i: one commit group
    if (i < n_used) {
      T* dst = ring + (i & 1) * 2 * kTile;
      stage_async<T, DP, kThreads, kStream>(dst, kh, L.k.t, i * kStream, Tk, D);
      stage_async<T, DP, kThreads, kStream>(dst + kTile, vh, L.v.t,
                                            i * kStream, Tk, D);
    }
    cp_async_commit();
  };
  fetch(0);
  // f32: q times scale before its split, as the plain version scales q
  const float qmul = kExact ? 1.f : scale;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_used; ++kt) {
    fetch(kt + 1);
    cp_async_wait<1>();  // q and tile kt have landed
    // every warp is past tile kt-1's math, which read the split tiles
    __syncthreads();
    split_tile<T, DP, kThreads>(kt_s, ring + (kt & 1) * 2 * kTile);
    split_tile<T, DP, kThreads>(vt_s, ring + (kt & 1) * 2 * kTile + kTile);
    // the split tiles are whole; stage kt & 1 is free for tile kt + 2
    __syncthreads();
    const int k0 = kt * kStream;
    // a warp whose 16 rows see none of the tile's keys (all past Tq, or
    // all above the tile when causal) skips its math: m, l and acc would
    // not change
    if (w0 >= Tq || (causal && w0 + 15 < k0)) continue;
    float s[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < DP; c += 8) {
      FragA fq;
      load_a<T, DP>(fq, qs, ln, r0, c, qmul);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        FragB fk;
        load_b_rows<DP>(fk, kt_s, lf, 8 * j, c);
        mma3<!kExact, !kExact>(s[j], fq, fk);
      }
    }
    // element e of s[j]: row w0 + gr + 8 (e >> 1), key k0 + 8j + 2tg +
    // (e & 1)
    bool valid[kNB][4];
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = w0 + gr + 8 * (e >> 1);
        const int kp = k0 + 8 * j + 2 * tg + (e & 1);
        valid[j][e] = kp < Tk && (!causal || qp >= kp);
        s[j][e] = valid[j][e] ? (kExact ? s[j][e] * scale : s[j][e])
                              : kNegInf;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    float corr[2], ps[2] = {0.f, 0.f}, ml[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mt[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      ml[i] = m_new * kLog2e;
    }
    // p = exp(s - m) is taken as 2^(s log2(e) - m log2(e)), an FFMA and an
    // ex2 where expf takes about ten instructions, for every score, and
    // then selected: a branch around each exp serialises the 16 of them
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
        s[j][e] = valid[j][e] ? p : 0.f;
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(ps[i]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      FragA fp;
      a_from_c(fp, s[j]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        FragB fv;
        load_b_cols<DP>(fv, vt_s, lf, 8 * j, 8 * n);
        mma3<true, !kExact>(acc[n], fp, fv);
      }
    }
  }
  cp_async_wait<0>();  // with Tk == 0 the loop never waited for q's copies
  // o = acc / l: a division, as the plain version; a row with no valid
  // key has acc == 0 and l == 0, and gets exact zeros
  const float den[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  T* out = o + (long long)bh * Tq * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    if (n * 8 < D) {
      const float c[4] = {acc[n][0] / den[0], acc[n][1] / den[0],
                          acc[n][2] / den[1], acc[n][3] / den[1]};
      store_c<T>(out, c, w0 + gr, Tq, D, n * 8 + 2 * tg, 1.f);
    }
  if (lse != nullptr && tg == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = w0 + gr + 8 * i;
      if (r < Tq)
        lse[(long long)bh * Tq + r] = l[i] > 0.f ? m[i] + logf(l[i])
                                                 : kLseEmpty;
    }
}

// The block shape of K2 and K3 for input type T at padded width DP. A
// block owns kRows rows (q rows in K2, keys in K3), a warp per 16 of them.
// f32 up to DP 64: 128 rows, one block of 8 warps an SM (128 KB of
// shared memory), which halves each thread's share of the tile splits and
// the streamed tile traffic against two blocks of 64 rows (measured 5 %
// faster); bf16 and DP 128 (whose 128 rows would not fit): 64 rows, as
// many blocks as the shared memory lets in, up to 3. Shared memory, K2:
// q and do [kRows][DP] and the two-stage K/V ring [2][2][32][DP] in the
// input type, the split K and V [4][32][DP] 32-bit; K3: K, V, the q/do
// ring and the split q and do alike, then its lse/delta rows, fp32:
// [2][2][32] as they land and [2][32] of the current tile.
template <typename T, int DP>
struct Bwd {
  static constexpr int kRows = sizeof(T) == 4 && DP <= 64 ? 128 : 64;
  static constexpr int kThreads = 2 * kRows;
  static constexpr size_t kSmemDq =
      (2 * (size_t)kRows + 4 * kStream) * DP * sizeof(T)
      + 4 * (size_t)kStream * DP * 4;
  static constexpr size_t kSmemDkv =
      kSmemDq + 6 * (size_t)kStream * sizeof(float);
  static constexpr int kFit = (int)(228 * 1024 / (kSmemDkv + 1024));
  static constexpr int kBlocks =
      kRows == 128 || kFit < 1 ? 1 : kFit > 3 ? 3 : kFit;
};

// K2. One block per (b*h, tile of kRows query rows); warp w owns rows
// 16w .. 16w+15. q and do are staged once; K and V tiles of 32 keys
// stream through a two-stage cp.async ring, the next tile loading during
// this one's math, and are split once into big/small tiles. Per tile:
// S = q.K^T and dP = do.V^T into C fragments; p = exp(S*scale - lse) and
// dS = p*(dP - delta) in registers; dq += dS.K with dS as the A operand
// straight from the C fragments; dq*scale at the store.
template <typename T, int DP>
__global__ void __launch_bounds__(Bwd<T, DP>::kThreads, Bwd<T, DP>::kBlocks)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Layout L, int H, int Tq, int Tk, int D, int causal,
                    float scale) {
  constexpr int kRows = Bwd<T, DP>::kRows;
  constexpr int kThreads = Bwd<T, DP>::kThreads;
  constexpr int kOwn = kRows * DP, kTile = kStream * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // q [kRows][DP]
  T* gs = qs + kOwn;                       // do
  T* ring = gs + kOwn;                     // [2][K, V][32][DP]
  uint32_t* sp = reinterpret_cast<uint32_t*>(ring + 4 * kTile);
  const SplitTile kt_s{sp, sp + kTile}, vt_s{sp + 2 * kTile, sp + 3 * kTile};
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tg = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const Lanes<T, DP> ln;
  const Lanes<float, DP> lf;
  const T* kh = k + b * L.k.b + h * L.k.h;
  const T* vh = v + b * L.v.b + h * L.v.h;
  stage_async<T, DP, kThreads, kRows>(qs, q + b * L.q.b + h * L.q.h, L.q.t,
                                      q0, Tq, D);
  stage_async<T, DP, kThreads, kRows>(gs, g + b * L.g.b + h * L.g.h, L.g.t,
                                      q0, Tq, D);
  cp_async_commit();
  const int nk = (Tk + kStream - 1) / kStream;
  const int n_used =
      causal ? min((q0 + kRows - 1) / kStream + 1, nk) : nk;
  auto fetch = [&](int i) {  // K and V of tile i: one commit group
    if (i < n_used) {
      T* dst = ring + (i & 1) * 2 * kTile;
      stage_async<T, DP, kThreads, kStream>(dst, kh, L.k.t, i * kStream, Tk, D);
      stage_async<T, DP, kThreads, kStream>(dst + kTile, vh, L.v.t,
                                            i * kStream, Tk, D);
    }
    cp_async_commit();
  };
  fetch(0);
  float lr[2], dr[2];  // lse and delta of rows r0 + gr and r0 + gr + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + gr + 8 * i;
    lr[i] = r < Tq ? lse[(long long)bh * Tq + r] : kLseEmpty;
    dr[i] = r < Tq ? delta[(long long)bh * Tq + r] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_used; ++kt) {
    fetch(kt + 1);
    cp_async_wait<1>();  // q, do and tile kt have landed
    // every warp is past tile kt-1's math, which read the split tiles
    __syncthreads();
    split_tile<T, DP, kThreads>(kt_s, ring + (kt & 1) * 2 * kTile);
    split_tile<T, DP, kThreads>(vt_s, ring + (kt & 1) * 2 * kTile + kTile);
    // the split tiles are whole; stage kt & 1 is free for tile kt + 2
    __syncthreads();
    const int k0 = kt * kStream;
    float s[kNB][4], dp[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < DP; c += 8) {
      FragA fq, fg;
      load_a<T, DP>(fq, qs, ln, r0, c);
      load_a<T, DP>(fg, gs, ln, r0, c);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        FragB fk, fv;
        load_b_rows<DP>(fk, kt_s, lf, 8 * j, c);
        load_b_rows<DP>(fv, vt_s, lf, 8 * j, c);
        mma3(s[j], fq, fk);
        mma3(dp[j], fg, fv);
      }
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + gr + 8 * (e >> 1);
        const int kp = k0 + 8 * j + 2 * tg + (e & 1);
        const bool valid = kp < Tk && (!causal || qp >= kp);
        const float p =
            valid ? expf(fmaf(s[j][e], scale, -lr[e >> 1])) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);  // dS
      }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      FragA fs;
      a_from_c(fs, s[j]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        FragB fk;
        load_b_cols<DP>(fk, kt_s, lf, 8 * j, 8 * n);
        mma3(acc[n], fs, fk);
      }
    }
  }
  T* out = dq + (long long)bh * Tq * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    if (n * 8 < D) store_c<T>(out, acc[n], q0 + r0 + gr, Tq, D,
                              n * 8 + 2 * tg, scale);
}

// K3. One block per (b*h, tile of kRows keys); warp w owns keys 16w ..
// 16w+15. K and V are staged once; q and do tiles of 32 rows (with their
// lse and delta) stream through the ring, from the diagonal when causal,
// and are split once into big/small tiles. Per q tile: the transposed
// S^T = K.q^T and dP^T = V.do^T, so a warp's rows are its own keys; P^T
// and dS^T stay in registers and feed dv += P^T.do and dk += dS^T.q as A
// operands; dk*scale at the store. lse and delta are indexed by the
// fragment's column, from shared memory.
template <typename T, int DP>
__global__ void __launch_bounds__(Bwd<T, DP>::kThreads, Bwd<T, DP>::kBlocks)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Layout L, int H, int Tq, int Tk,
                     int D, int causal, float scale) {
  constexpr int kRows = Bwd<T, DP>::kRows;
  constexpr int kThreads = Bwd<T, DP>::kThreads;
  constexpr int kOwn = kRows * DP, kTile = kStream * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // K [kRows][DP]
  T* vs = ks + kOwn;
  T* ring = vs + kOwn;                     // [2][q, do][32][DP]
  uint32_t* sp = reinterpret_cast<uint32_t*>(ring + 4 * kTile);
  const SplitTile qt_s{sp, sp + kTile}, gt_s{sp + 2 * kTile, sp + 3 * kTile};
  // [2][lse, delta][32] as they land, then the current tile's [2][32]
  float* lring = reinterpret_cast<float*>(sp + 4 * kTile);
  float* lrs = lring + 4 * kStream;
  float* drs = lrs + kStream;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, lane = tid & 31, gr = lane >> 2, tg = lane & 3;
  const int r0 = (tid >> 5) * 16;
  const Lanes<T, DP> ln;
  const Lanes<float, DP> lf;
  const T* qh = q + b * L.q.b + h * L.q.h;
  const T* gh = g + b * L.g.b + h * L.g.h;
  const float* lh = lse + (long long)bh * Tq;
  const float* dh = delta + (long long)bh * Tq;
  stage_async<T, DP, kThreads, kRows>(ks, k + b * L.k.b + h * L.k.h, L.k.t,
                                      k0, Tk, D);
  stage_async<T, DP, kThreads, kRows>(vs, v + b * L.v.b + h * L.v.h, L.v.t,
                                      k0, Tk, D);
  cp_async_commit();
  const int nq = (Tq + kStream - 1) / kStream;
  const int i0 = causal ? k0 / kStream : 0;
  auto fetch = [&](int it) {  // q, do, lse and delta of tile it
    if (it < nq) {
      T* dst = ring + (it & 1) * 2 * kTile;
      stage_async<T, DP, kThreads, kStream>(dst, qh, L.q.t, it * kStream, Tq,
                                            D);
      stage_async<T, DP, kThreads, kStream>(dst + kTile, gh, L.g.t,
                                            it * kStream, Tq, D);
      if (tid < kStream) {
        // rows past Tq are zero-filled and never read: their p is
        // masked to 0 below
        const int r = it * kStream + tid;
        float* rows = lring + (it & 1) * 2 * kStream;
        cp_async4(rows + tid, r < Tq ? lh + r : lh, r < Tq ? 4 : 0);
        cp_async4(rows + kStream + tid, r < Tq ? dh + r : dh,
                  r < Tq ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  fetch(i0);
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = i0; it < nq; ++it) {
    fetch(it + 1);
    cp_async_wait<1>();  // K, V and tile it have landed
    // every warp is past tile it-1's math, which read the split tiles
    __syncthreads();
    const T* raw = ring + (it & 1) * 2 * kTile;
    split_tile<T, DP, kThreads>(qt_s, raw);
    split_tile<T, DP, kThreads>(gt_s, raw + kTile);
    if (tid < 2 * kStream) lrs[tid] = lring[(it & 1) * 2 * kStream + tid];
    // the split tiles are whole; stage it & 1 is free for tile it + 2
    __syncthreads();
    const int q0 = it * kStream;
    float s[kNB][4], dp[kNB][4];  // rows: keys; columns: q rows
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < DP; c += 8) {
      FragA fk, fv;
      load_a<T, DP>(fk, ks, ln, r0, c);
      load_a<T, DP>(fv, vs, ln, r0, c);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        FragB fq, fg;
        load_b_rows<DP>(fq, qt_s, lf, 8 * j, c);
        load_b_rows<DP>(fg, gt_s, lf, 8 * j, c);
        mma3(s[j], fk, fq);
        mma3(dp[j], fv, fg);
      }
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + r0 + gr + 8 * (e >> 1);
        const int ql = 8 * j + 2 * tg + (e & 1), qp = q0 + ql;
        const bool valid = qp < Tq && kp < Tk && (!causal || qp >= kp);
        const float p = valid ? expf(fmaf(s[j][e], scale, -lrs[ql])) : 0.f;
        s[j][e] = p;                           // P^T
        dp[j][e] = p * (dp[j][e] - drs[ql]);   // dS^T
      }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      FragA fp, fs;
      a_from_c(fp, s[j]);
      a_from_c(fs, dp[j]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        FragB fg, fq;
        load_b_cols<DP>(fg, gt_s, lf, 8 * j, 8 * n);
        load_b_cols<DP>(fq, qt_s, lf, 8 * j, 8 * n);
        mma3(dva[n], fp, fg);
        mma3(dka[n], fs, fq);
      }
    }
  }
  // key rows past Tk (the KV padding of the last tile) are never stored
  const long long o = (long long)bh * Tk * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    if (n * 8 < D) {
      store_c<T>(dk + o, dka[n], k0 + r0 + gr, Tk, D, n * 8 + 2 * tg,
                 scale);
      store_c<T>(dv + o, dva[n], k0 + r0 + gr, Tk, D, n * 8 + 2 * tg, 1.f);
    }
}

// Shared memory above 48 KB needs the opt-in, once per instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

// DP: the padded head width the tiles use for a head width D.
#define DL4J_DP_SWITCH(D, ...)                                           \
  if (D <= 0 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;     \
  if (D <= 16) { constexpr int DP = 16; __VA_ARGS__; }                   \
  else if (D <= 32) { constexpr int DP = 32; __VA_ARGS__; }              \
  else if (D <= 64) { constexpr int DP = 64; __VA_ARGS__; }              \
  else { constexpr int DP = 128; __VA_ARGS__; }

template <typename T, int DP>
int run_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
            const Layout& L, int B, int H, int Tq, int Tk, int D, int causal,
            float scale, cudaStream_t st) {
  static bool done = false;
  using C = Fwd<T, DP>;
  const size_t shm = C::kSmem;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DP>, shm, &done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + C::kRows - 1) / C::kRows);
  flash_fwd_kernel<T, DP><<<grid, C::kThreads, shm, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      L, H, Tq, Tk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int run_dq(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dq, const Layout& L,
           int B, int H, int Tq, int Tk, int D, int causal, float scale,
           cudaStream_t st) {
  static bool done = false;
  using C = Bwd<T, DP>;
  const size_t shm = C::kSmemDq;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DP>, shm, &done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + C::kRows - 1) / C::kRows);
  flash_bwd_dq_kernel<T, DP><<<grid, C::kThreads, shm, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), L, H, Tq, Tk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int run_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv,
            const Layout& L, int B, int H, int Tq, int Tk, int D, int causal,
            float scale, cudaStream_t st) {
  static bool done = false;
  using C = Bwd<T, DP>;
  const size_t shm = C::kSmemDkv;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DP>, shm, &done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tk + C::kRows - 1) / C::kRows);
  flash_bwd_dkv_kernel<T, DP><<<grid, C::kThreads, shm, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, Tq, Tk, D, causal,
      scale);
  return (int)cudaGetLastError();
}

// strides: 12 host int64 values, (b, h, t) of q, k, v, do in that order
Layout layout(const long long* s) {
  return Layout{{s[0], s[1], s[2]}, {s[3], s[4], s[5]},
                {s[6], s[7], s[8]}, {s[9], s[10], s[11]}};
}

}  // namespace

// The C interface ops/_kernels.py binds with ctypes. Each launches on the
// given stream and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head width that is not a multiple of 8 in
// 8..128. The wrapper guarantees B*H, Tq and Tk > 0 and 16-byte aligned
// rows.
extern "C" {

int dl4j_flash_fwd_f32(const void* q, const void* k, const void* v,
                       void* o, void* lse, const long long* strides, int B,
                       int H, int Tq, int Tk, int D, int causal, float scale,
                       void* stream) {
  const Layout L = layout(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DL4J_DP_SWITCH(D, return run_fwd<float, DP>(q, k, v, o, lse, L, B, H, Tq, Tk,
                                            D, causal, scale, st))
}

int dl4j_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dq, const long long* strides, int B, int H,
                          int Tq, int Tk, int D, int causal, float scale,
                          void* stream) {
  const Layout L = layout(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DL4J_DP_SWITCH(D, return run_dq<float, DP>(q, k, v, g, lse, delta, dq, L, B,
                                           H, Tq, Tk, D, causal, scale, st))
}

int dl4j_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                           const void* g, const void* lse, const void* delta,
                           void* dk, void* dv, const long long* strides,
                           int B, int H, int Tq, int Tk, int D, int causal,
                           float scale, void* stream) {
  const Layout L = layout(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DL4J_DP_SWITCH(D, return run_dkv<float, DP>(q, k, v, g, lse, delta, dk, dv, L,
                                            B, H, Tq, Tk, D, causal, scale,
                                            st))
}

int dl4j_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       void* o, void* lse, const long long* strides, int B,
                       int H, int Tq, int Tk, int D, int causal, float scale,
                       void* stream) {
  const Layout L = layout(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DL4J_DP_SWITCH(D, return run_fwd<__nv_bfloat16, DP>(q, k, v, o, lse, L, B, H, Tq, Tk,
                                            D, causal, scale, st))
}

int dl4j_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dq, const long long* strides, int B, int H,
                          int Tq, int Tk, int D, int causal, float scale,
                          void* stream) {
  const Layout L = layout(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DL4J_DP_SWITCH(D, return run_dq<__nv_bfloat16, DP>(q, k, v, g, lse, delta, dq, L, B,
                                           H, Tq, Tk, D, causal, scale, st))
}

int dl4j_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                           const void* g, const void* lse, const void* delta,
                           void* dk, void* dv, const long long* strides,
                           int B, int H, int Tq, int Tk, int D, int causal,
                           float scale, void* stream) {
  const Layout L = layout(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DL4J_DP_SWITCH(D, return run_dkv<__nv_bfloat16, DP>(q, k, v, g, lse, delta, dk, dv, L,
                                            B, H, Tq, Tk, D, causal, scale,
                                            st))
}

}  // extern "C"
