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
// product and sum is taken in fp32 (K2 and K3: products in 3xTF32, as
// accurate) and each output is rounded once to the input type. D is any
// multiple of 8 up to 128: the tiles are padded with zeros to DP in {16,
// 32, 64, 128}, which adds exact zeros to every dot product.
//
// What bounds them on the H100: operations. At the training shapes (B 8,
// H 12, T 512, D 64) K1 does 4*B*H*T^2*D = 6.4 GFLOP on 50 MB of q/k/v/o
// (~128 flop per byte), K2 1.5x and K3 2x K1's flops; the bytes take
// 0.015 ms at 3.35 TB/s. For f32 work the card's fastest fp32-accurate
// route is 3xTF32 on the tensor cores: 495/3 = 165 TFLOP/s, against 67 on
// the CUDA cores.
//
// K1 (forward) runs on the CUDA cores: every (row, key) score is computed
// once from tiles staged in shared memory (64 query rows x 64 keys,
// 16-byte global loads converted to fp32 on the way in), and each of 256
// threads computes a 4x4 block of the score tile and a 4 x DP/16 block of
// the output tile from registers, so each shared-memory read feeds four
// FMAs. The padded row stride (DP + 1) keeps the 16 threads that read 16
// different rows in 16 different banks.
//
// K2 (dq) and K3 (dk/dv) run every product on the tensor cores in 3xTF32
// (mma.sync m16n8k8, fp32 accumulators; the comment that opens their
// section says how), a warp per 16 rows of the block's own 64 or 128. The
// scores, probabilities and dS never leave registers: a C fragment is the
// A operand of the next product. K/V (K2) or q/do (K3) tiles of 32 rows
// stream through a two-stage ring of 16-byte cp.async copies into
// XOR-swizzled tiles, the next tile loading while this one is multiplied,
// and each is split into its TF32 parts once per block. What bounds them
// is the instruction rate and latency: a product takes three MMAs, the
// splits and the per-k-step adds, and a warp has few independent ones in
// flight.
//
// Causal tiles wholly above the diagonal are skipped (K1, K2: the KV loop
// ends at the last tile the q tile can see; K3: the q loop starts at the
// diagonal), as the reference skips its blocks. The TPU kernels hold the
// whole K/V (or q/do) of a head in VMEM and loop with fori_loop; here a
// block stages one tile at a time, and blocks run in no order, so a
// block owns its output tile outright: dq belongs to K2, dk/dv to K3, no
// kernel uses atomics, and every sum has one fixed order, so two runs on
// the same inputs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr float kLseEmpty = 1e30f;  // lse of a row with no valid key
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kBQ = 64;             // query rows per tile
constexpr int kBK = 64;             // keys per tile
constexpr int kPS = kBK + 16;       // row stride of a [kBQ][kBK] prob tile

struct Strides {  // element strides of one [B, H, T, D] operand (D stride 1)
  long long b, h, t;
};
struct Layout {   // q, k, v, and do (backward) or unused (forward)
  Strides q, k, v, g;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Unpack one 16-byte chunk into fp32 values.
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage rows row0 .. row0+63 of one head (base `src`, row stride `rs`) into
// dst [64][DP + 1] fp32, times `mul`. Rows at or past `n` and columns at or
// past D are zeros, so padded rows and columns add nothing.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int row0, int n, int D, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int d0 = (i - r * kChunks) * kVec;
    float vals[kVec];
    if (row0 + r < n && d0 < D) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * rs + d0);
      unpack(u, vals, src);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
    float* row = dst + r * (DP + 1) + d0;
#pragma unroll
    for (int e = 0; e < kVec; ++e) row[e] = vals[e] * mul;
  }
}

// Max and sum over the 16 lanes that share a row (lanes differ in their low
// four bits). Butterflies: every lane ends with the same value.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[i][j] = a[row ty+16i] . b[row tx+16j] over DP, from [64][DP+1] tiles
template <int DP>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (DP + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (DP + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += x[i] * y[j];
  }
}

// K1. One block per (b*h, tile of 64 query rows); thread (ty, tx) owns query
// rows ty + 16i, score columns tx + 16j and output columns tx + 16jd. Per
// KV tile: stage K and V, score, fold into the online softmax (m, l, acc in
// registers, fp32), write p to shared memory, accumulate p.V.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Layout L, int H, int Tq, int Tk,
                 int D, int causal, float scale) {
  constexpr int DC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [64][DP+1], times scale
  float* ks = qs + kBQ * (DP + 1);    // [64][DP+1]
  float* vs = ks + kBK * (DP + 1);    // [64][DP+1]
  float* ps = vs + kBK * (DP + 1);    // [64][kPS]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qh = q + b * L.q.b + h * L.q.h;
  const T* kh = k + b * L.k.b + h * L.k.h;
  const T* vh = v + b * L.v.b + h * L.v.h;
  stage<T, DP>(qs, qh, L.q.t, q0, Tq, D, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) acc[i][jd] = 0.f;
  }
  const int nk = (Tk + kBK - 1) / kBK;
  const int n_used = causal ? min((q0 + kBQ - 1) / kBK + 1, nk) : nk;
  for (int kt = 0; kt < n_used; ++kt) {
    const int k0 = kt * kBK;
    stage<T, DP>(ks, kh, L.k.t, k0, Tk, D, 1.f);
    stage<T, DP>(vs, vh, L.v.t, k0, Tk, D, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<DP>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool valid[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        valid[j] = kp < Tk && (!causal || qp >= kp);
        if (!valid[j]) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) vv[jd] = vs[c * (DP + 1) + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] += pr[i] * vv[jd];
    }
    __syncthreads();  // the next tile rewrites ks, vs and ps
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((long long)bh * Tq + r) * D;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) orow[d] = from_f32<T>(acc[i][jd] / den);
    }
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * Tq + r] = l[i] > 0.f ? m[i] + logf(l[i]) : kLseEmpty;
  }
}

// ---------------------------------------------------------------------------
// K2 and K3: the backward's products on the tensor cores, fp32-accurate.
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
// the size of its 8 products, and d's sum rounds to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
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

// Start the copies of `rows` rows from row0 of one head (base `src`, row
// stride `rs` elements) into the swizzled tile `dst`; rows at or past `n`
// and columns at or past D are zero-filled (D is a multiple of 8, so a
// chunk is wholly in or out).
template <typename T, int DP, int THREADS>
__device__ __forceinline__ void stage_async(T* dst, const T* src,
                                            long long rs, int row0, int rows,
                                            int n, int D) {
  constexpr int kCh = Swz<T, DP>::kCh, kNc = Swz<T, DP>::kNc;
  for (int i = threadIdx.x; i < rows * kNc; i += THREADS) {
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

// Rows of a streamed tile: K/V (K2) or q/do (K3), 4 blocks of 8 (16 rows
// measured slower on the H100: more barriers and A-operand splits for the
// same work)
constexpr int kStream = 32;
constexpr int kNB = kStream / 8;

// A operand: rows r0 .. r0+15, columns c0 .. c0+7 of a tile in the input
// type, split as it is loaded
template <typename T, int DP>
__device__ __forceinline__ void load_a(FragA& f, const T* tile,
                                       const Lanes<T, DP>& ln, int r0,
                                       int c0) {
  const T* p = tile + r0 * DP + ln.row + (c0 ^ ln.xrow);
  const float2 x = ld2(p), y = ld2(p + 8 * DP);
  split(x.x, f.big[0], f.small[0]);
  split(y.x, f.big[1], f.small[1]);
  split(x.y, f.big[2], f.small[2]);
  split(y.y, f.big[3], f.small[3]);
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
  for (int i = threadIdx.x; i < kStream * DP / 4; i += THREADS) {
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
  stage_async<T, DP, kThreads>(qs, q + b * L.q.b + h * L.q.h, L.q.t, q0,
                               kRows, Tq, D);
  stage_async<T, DP, kThreads>(gs, g + b * L.g.b + h * L.g.h, L.g.t, q0,
                               kRows, Tq, D);
  cp_async_commit();
  const int nk = (Tk + kStream - 1) / kStream;
  const int n_used =
      causal ? min((q0 + kRows - 1) / kStream + 1, nk) : nk;
  auto fetch = [&](int i) {  // K and V of tile i: one commit group
    if (i < n_used) {
      T* dst = ring + (i & 1) * 2 * kTile;
      stage_async<T, DP, kThreads>(dst, kh, L.k.t, i * kStream, kStream,
                                   Tk, D);
      stage_async<T, DP, kThreads>(dst + kTile, vh, L.v.t, i * kStream,
                                   kStream, Tk, D);
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
  stage_async<T, DP, kThreads>(ks, k + b * L.k.b + h * L.k.h, L.k.t, k0,
                               kRows, Tk, D);
  stage_async<T, DP, kThreads>(vs, v + b * L.v.b + h * L.v.h, L.v.t, k0,
                               kRows, Tk, D);
  cp_async_commit();
  const int nq = (Tq + kStream - 1) / kStream;
  const int i0 = causal ? k0 / kStream : 0;
  auto fetch = [&](int it) {  // q, do, lse and delta of tile it
    if (it < nq) {
      T* dst = ring + (it & 1) * 2 * kTile;
      stage_async<T, DP, kThreads>(dst, qh, L.q.t, it * kStream, kStream,
                                   Tq, D);
      stage_async<T, DP, kThreads>(dst + kTile, gh, L.g.t, it * kStream,
                                   kStream, Tq, D);
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

constexpr size_t tile_bytes(int dp) { return (size_t)64 * (dp + 1) * 4; }
constexpr size_t fwd_smem(int dp) { return 3 * tile_bytes(dp) + kBQ * kPS * 4; }
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
  const size_t shm = fwd_smem(DP);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DP>, shm, &done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, DP><<<grid, kThreads, shm, st>>>(
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
