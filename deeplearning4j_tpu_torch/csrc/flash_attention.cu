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
// product and sum is taken in fp32 and each output is rounded once to the
// input type. D is any multiple of 8 up to 128: the tiles are padded with
// zeros to DP in {16, 32, 64, 128}, which adds exact zeros to every dot
// product.
//
// What bounds them on the H100: operations. At the training shapes (B 8,
// H 12, T 512, D 64) K1 does 4*B*H*T^2*D = 6.4 GFLOP on 50 MB of q/k/v/o
// (~128 flop per byte): 0.096 ms at the 67 TFLOP/s fp32 CUDA-core peak
// against 0.015 ms for the bytes at 3.35 TB/s; K2 does 1.5x and K3 2x K1's
// flops. In bf16 the tensor cores (989 TFLOP/s) would move the bound to the
// bytes; these kernels do not use them. What the design does about it:
// every (row, key) score is computed once per kernel from tiles staged in
// shared memory (64 query rows x 64 keys, 16-byte global loads converted to
// fp32 on the way in), and each of 256 threads computes a 4x4 block of the
// score tile and a 4 x DP/16 block of the output tile from registers, so
// each shared-memory read feeds four FMAs. The padded row stride (DP + 1)
// keeps the 16 threads that read 16 different rows in 16 different banks.
// Causal tiles wholly above the diagonal are skipped (K1, K2: the KV loop
// ends at the last tile the q tile can see; K3: the q loop starts at the
// diagonal), as the reference skips its blocks. The TPU kernels hold the
// whole K/V (or q/do) of a head in VMEM and loop with fori_loop; here a
// block stages one 64-row tile at a time, and blocks run in no order, so a
// block owns its output tile outright: dq belongs to K2, dk/dv to K3, no
// kernel uses atomics, and every sum has one fixed order, so two runs on
// the same inputs are bitwise equal. Tensor-core products (wgmma), TMA
// copies and overlapping a tile's loads with the previous tile's math are
// later work.

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

// K2. One block per (b*h, tile of 64 query rows). Per KV tile: stage K and
// V; s = (q*scale).k^T and dp = do.v^T from registers; ds = p*(dp - delta)
// with p rebuilt from the lse; write ds to shared memory; dq += ds.K.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Layout L, int H, int Tq, int Tk, int D, int causal,
                    float scale) {
  constexpr int DC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [64][DP+1], times scale
  float* gs = qs + kBQ * (DP + 1);    // do [64][DP+1]
  float* ks = gs + kBQ * (DP + 1);
  float* vs = ks + kBK * (DP + 1);
  float* dss = vs + kBK * (DP + 1);   // ds [64][kPS]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kh = k + b * L.k.b + h * L.k.h;
  const T* vh = v + b * L.v.b + h * L.v.h;
  stage<T, DP>(qs, q + b * L.q.b + h * L.q.h, L.q.t, q0, Tq, D, scale);
  stage<T, DP>(gs, g + b * L.g.b + h * L.g.h, L.g.t, q0, Tq, D, 1.f);
  float lr[4], dr[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lr[i] = r < Tq ? lse[(long long)bh * Tq + r] : kLseEmpty;
    dr[i] = r < Tq ? delta[(long long)bh * Tq + r] : 0.f;
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
    float s[4][4], dp[4][4];
    tile_dot<DP>(s, qs, ks, ty, tx);
    tile_dot<DP>(dp, gs, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool valid = kp < Tk && (!causal || qp >= kp);
        const float p = valid ? expf(s[i][j] - lr[i]) : 0.f;
        dss[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float x[4], y[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = dss[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) y[jd] = ks[c * (DP + 1) + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] += x[i] * y[jd];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    T* row = dq + ((long long)bh * Tq + r) * D;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) row[d] = from_f32<T>(acc[i][jd] * scale);
    }
  }
}

// K3. One block per (b*h, tile of 64 keys); thread (ty, tx) owns key rows
// ty + 16i and output columns tx + 16jd of dk and dv. Per q tile, from the
// diagonal when causal: stage q*scale and do; p and ds for the [64 q x 64
// k] tile as in K2, into shared memory; dv += p^T.do, dk += ds^T.(q*scale).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Layout L, int H, int Tq, int Tk,
                     int D, int causal, float scale) {
  constexpr int DC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [64][DP+1]
  float* vs = ks + kBK * (DP + 1);
  float* qs = vs + kBK * (DP + 1);    // [64][DP+1], times scale
  float* gs = qs + kBQ * (DP + 1);    // do
  float* pss = gs + kBQ * (DP + 1);   // p  [64 q][kPS]
  float* dss = pss + kBQ * kPS;       // ds [64 q][kPS]
  float* lrs = dss + kBQ * kPS;       // lse of the tile's rows [64]
  float* drs = lrs + kBQ;             // delta [64]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qh = q + b * L.q.b + h * L.q.h;
  const T* gh = g + b * L.g.b + h * L.g.h;
  stage<T, DP>(ks, k + b * L.k.b + h * L.k.h, L.k.t, k0, Tk, D, 1.f);
  stage<T, DP>(vs, v + b * L.v.b + h * L.v.h, L.v.t, k0, Tk, D, 1.f);
  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) dka[i][jd] = dva[i][jd] = 0.f;
  const int nq = (Tq + kBQ - 1) / kBQ;
  const int i0 = causal ? k0 / kBQ : 0;
  for (int it = i0; it < nq; ++it) {
    const int q0 = it * kBQ;
    stage<T, DP>(qs, qh, L.q.t, q0, Tq, D, scale);
    stage<T, DP>(gs, gh, L.g.t, q0, Tq, D, 1.f);
    if (tid < kBQ) {
      const int r = q0 + tid;
      lrs[tid] = r < Tq ? lse[(long long)bh * Tq + r] : kLseEmpty;
      drs[tid] = r < Tq ? delta[(long long)bh * Tq + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DP>(s, qs, ks, ty, tx);   // rows: q (ty+16i), cols: k (tx+16j)
    tile_dot<DP>(dp, gs, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i, qp = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool valid = qp < Tq && kp < Tk && (!causal || qp >= kp);
        const float p = valid ? expf(s[i][j] - lrs[rl]) : 0.f;
        pss[rl * kPS + tx + 16 * j] = p;
        dss[rl * kPS + tx + 16 * j] = p * (dp[i][j] - drs[rl]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pr[4], dr[4], gq[DC], qq[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = pss[r * kPS + ty + 16 * i];
        dr[i] = dss[r * kPS + ty + 16 * i];
      }
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) {
        gq[jd] = gs[r * (DP + 1) + tx + 16 * jd];
        qq[jd] = qs[r * (DP + 1) + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) {
          dva[i][jd] += pr[i] * gq[jd];
          dka[i][jd] += dr[i] * qq[jd];
        }
    }
    __syncthreads();  // the next q tile rewrites qs, gs, pss, dss, lrs, drs
  }
  // rows past Tk (the KV padding of the last tile) are never stored
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Tk) continue;
    T* krow = dk + ((long long)bh * Tk + r) * D;
    T* vrow = dv + ((long long)bh * Tk + r) * D;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) {
        krow[d] = from_f32<T>(dka[i][jd]);
        vrow[d] = from_f32<T>(dva[i][jd]);
      }
    }
  }
}

constexpr size_t tile_bytes(int dp) { return (size_t)64 * (dp + 1) * 4; }
constexpr size_t fwd_smem(int dp) { return 3 * tile_bytes(dp) + kBQ * kPS * 4; }
constexpr size_t dq_smem(int dp) { return 4 * tile_bytes(dp) + kBQ * kPS * 4; }
constexpr size_t dkv_smem(int dp) {
  return 4 * tile_bytes(dp) + 2 * (size_t)kBQ * kPS * 4 + 2 * kBQ * 4;
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
  const size_t shm = dq_smem(DP);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DP>, shm, &done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, shm, st>>>(
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
  const size_t shm = dkv_smem(DP);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DP>, shm, &done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tk + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, shm, st>>>(
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
