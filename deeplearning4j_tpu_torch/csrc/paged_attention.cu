// Paged KV attention for Hopper (sm_90a): block-table decode and chunked
// prefill over a paged KV pool, the serving path's two attention kernels.
//
// Replaces, in deeplearning4j_tpu/ops/pallas_attention.py:
//   _paged_decode_kernel  (launched by paged_flash_decode)
//       -> paged_decode_split_kernel + paged_combine_kernel
//   _paged_prefill_kernel (launched by paged_flash_prefill)
//       -> paged_prefill_split_kernel + paged_combine_kernel
// and computes what they compute: softmax attention with fp32 sums, the
// mask (k_pos < length) & (q_pos >= k_pos), the reference's finite -1e30
// mask value, an exact zero row where no key is valid and (decode) the
// +1e30 lse sentinel there. Inputs and outputs are fp32 or bf16; the
// output is rounded once to the input type.
//
// Layouts (row-major, contiguous; ops/paged_attention.py checks them):
//   pools      [P, page, H, Dh]  one layer's K or V, 16-byte aligned
//   decode     q [S, H, Dh], bt [S, MP] int32, seq_lens [S] int32,
//              out [S, H, Dh], lse [S, H] fp32 or null
//   prefill    q [C, H, Dh], bt [MP] int32, out [C, H, Dh]; t0 and
//              n_valid arrive as host ints, so no launch reads a device
//              scalar back to the host
//   workspace  fp32, allocated by the wrapper: acc [U, NS, Dh] then
//              (m, l) [U, NS, 2], U = S*H (decode) or C*H (prefill) rows,
//              NS = ceil(MP / kSplitPages) splits
//
// What bounds them on the H100: bytes. Each live K and V row is used for
// 2*Dh flops per query row, so decode does ~0.5 flop per byte of bf16 KV
// and a 16-row prefill chunk ~8, far below the card's ~295 flop/byte
// balance point: the floor is the live K and V bytes over 3.35 TB/s. At
// the served sizes that floor is a few microseconds, so what the kernels
// must avoid is latency: a serial walk of the longest slot inside one
// block, one key at a time, with no load in flight during the math.
//
// The split plan. The KV walk is cut into spans of kSplitPages logical
// pages (64 keys at page 16). Decode runs a grid (S, H, NS), prefill
// (H, NS, ceil(C/16)); a block whose span starts at or past its row's
// length returns at once. Each working block stages its span's K and V
// pages through the block table with 16-byte cp.async copies into a
// two-stage ring of tiles (K and V of a tile are separate commit groups,
// so scores start while V is still in flight and tile i+1 loads during
// tile i's math), computes the span's (m, l, acc[Dh]) with an online
// softmax over its tiles, and writes them to the workspace. The combine
// kernel then merges a row's live splits in split order:
//   m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / l,
// lse = m + log l; l == 0 gives exact zeros and the sentinel. There are
// no atomics and every sum has one fixed order, so a result is bitwise
// repeatable. The plan depends only on the row's own length and the
// constants below, never on S, the slot bucket, physical page ids or the
// other slots: a slot's row is the same bits alone and in any batch, and
// the paged and dense (identity block table) paths agree bit for bit.
//
// K4 (decode) stays on the CUDA cores: each (slot, head) has one query
// row and its own K/V head, so a 16-row MMA tile would be 15/16 empty,
// and the bound is bytes. Its lanes split a key's Dh into 16-byte
// vectors (8 lanes per key at Dh 64 bf16, 4 keys per warp at once, a
// 3-step shuffle); max, exp and sum are block reductions with one thread
// per key; for P.V each thread owns one 16-byte slice of Dh for a subset
// of the keys, and the partial sums are reduced through shared memory in
// a fixed order.
//
// K5 (prefill) takes the chunk's 16-row query tile (C == page rows, zero
// padded to 16) against each key tile: S = Q.K^T, then the online
// softmax per row in fp32, 8 threads a row, then P.V. Both products run
// on the CUDA cores, for bf16 as for fp32 inputs:
// - Q.K^T as fp32 FMAs in Dh order, one (row, key) pair per thread and
//   step, the scale 1/sqrt(Dh) applied to the fp32 score so no Dh rounds
//   q. A tensor-core Q.K^T (mma.sync.m16n8k16, bf16 in, fp32 accumulate)
//   is as close to an f64 answer, but its sums round differently from the
//   plain version's, and on the smoke's own t0=1008 chunk that puts
//   outputs near zero more than one bf16 ulp from the plain version,
//   which the smoke's per-input "at most 1 ulp" check does not allow.
//   Moving Q.K^T to the tensor cores waits on a restatement of that check
//   (ROADMAP.md, Queue 2).
// - P.V in fp32 with P unrounded and V converted exactly, as in the
//   reference (P fp32 times V cast to fp32). A bf16 P for the tensor
//   cores moves each weight by up to 2^-9 relative. Split into
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), two MMAs against the exact
//   V leave 2^-17: measured, that lands an order of magnitude further
//   from an f64 answer than the fp32 sums and more than one bf16 ulp from
//   the plain version on most inputs, for a few per cent of K5's time
//   (PERF.md, PR 3). It stays out.
// No TF32 either: its 10-bit mantissa would break rtol 1e-5.
//
// Every tile fits 48 KB of shared memory (the launchers halve the tile
// until it does), so no launch needs the opt-in attribute at the head
// widths instantiated; a larger one would get it, never another path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplitPages = 4;      // logical pages per split (the plan)
constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr float kLseEmpty = 1e30f;  // lse of a row with no valid key
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;           // prefill query rows per block
constexpr size_t kMaxShared = 48 * 1024;  // no opt-in attribute needed

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// N contiguous T of shared memory as fp32, in the widest loads their
// alignment (a multiple of N * sizeof(T) bytes) allows
template <typename T, int N>
__device__ __forceinline__ void load_f32(float* dst, const T* src) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kChunk = kBytes % 16 == 0 ? 16 : kBytes % 8 == 0 ? 8
                         : kBytes % 4 == 0 ? 4 : (int)sizeof(T);
  constexpr int kPer = kChunk / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    alignas(kChunk) T e[kPer];
    if constexpr (kChunk == 16) {
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(src)[c];
    } else if constexpr (kChunk == 8) {
      *reinterpret_cast<uint2*>(e) = reinterpret_cast<const uint2*>(src)[c];
    } else if constexpr (kChunk == 4) {
      *reinterpret_cast<uint32_t*>(e) =
          reinterpret_cast<const uint32_t*>(src)[c];
    } else {
      e[0] = src[c];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[c * kPer + i] = to_f32(e[i]);
  }
}

// butterfly reductions over aligned groups of N lanes: every lane of a
// group ends with the same value, in a fixed order
template <int N>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int N>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide max / sum: warps in order, every thread gets the result
__device__ __forceinline__ float block_max(float v, float* wred) {
  v = group_max<32>(v);
  if ((threadIdx.x & 31) == 0) wred[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = wred[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, wred[w]);
  __syncthreads();  // wred is reused
  return r;
}
__device__ __forceinline__ float block_sum(float v, float* wred) {
  v = group_sum<32>(v);
  if ((threadIdx.x & 31) == 0) wred[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = wred[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += wred[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue cp.async copies of `nrows` K or V rows of head h, starting at
// key `k` of the span (page ids in shared `pg`), into dst [nrows][stride],
// 16 bytes per copy, neighbouring threads on neighbouring addresses.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* pool,
                                           const int* pg, int k, int nrows,
                                           int page, size_t hd, int h) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = DH / kVec;
  for (int i = threadIdx.x; i < nrows * kRowVecs; i += kThreads) {
    const int row = i / kRowVecs, c = i - row * kRowVecs;
    const int kp = k + row, j = kp / page;
    cp_async16(dst + (size_t)row * stride + c * kVec,
               pool + ((size_t)pg[j] * page + (kp - j * page)) * hd
                   + (size_t)h * DH + c * kVec);
  }
}

// K4, one split. Block (slot s, head h, split z) over keys
// [z * span, min((z + 1) * span, len)); TK keys per ring tile.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                          const T* __restrict__ vpool,
                          const int* __restrict__ bt,
                          const int* __restrict__ seq_lens,
                          float* __restrict__ ws_acc,
                          float* __restrict__ ws_ml, int H, int page, int MP,
                          int NS, int TK, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLpk = DH / kVec;           // lanes per key: 1..32
  constexpr int kKpw = 32 / kLpk;           // keys a warp scores at once
  constexpr int kGroups = kThreads / kLpk;  // key groups of the P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [2][K, V][TK][DH]
  float* sc = reinterpret_cast<float*>(ring + 4 * (size_t)TK * DH);  // [TK]
  float* red = sc + TK;                      // [kGroups][DH]
  float* wred = red + kGroups * DH;          // [kWarps]
  int* pg = reinterpret_cast<int*>(wred + kWarps);  // [kSplitPages]

  const int s = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int span = kSplitPages * page, k0 = split * span;
  // a length past the table's reach reads no entry beyond its row
  const int len = min(seq_lens[s], MP * page);
  if (k0 >= len) return;  // a dead split: the combine never reads it
  const int nkeys = min(span, len - k0);
  const int ntiles = (nkeys + TK - 1) / TK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % kLpk, g = tid / kLpk;  // 16-byte slice, key group
  const size_t hd = (size_t)H * DH;
  const size_t unit = (size_t)s * H + h;
  if (tid < kSplitPages && split * kSplitPages + tid < MP)
    pg[tid] = bt[(size_t)s * MP + split * kSplitPages + tid];
  float qv[kVec];  // this lane's slice of the scaled query
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    qv[e] = to_f32(q[unit * DH + sub * kVec + e]) * scale;
  __syncthreads();  // pg

  const int stage = 2 * TK * DH;
  auto fetch = [&](int i) {  // tile i's K and V: two commit groups
    T* dst = ring + (i & 1) * stage;
    const int n = i < ntiles ? min(TK, nkeys - i * TK) : 0;
    stage_rows<T, DH>(dst, DH, kpool, pg, i * TK, n, page, hd, h);
    cp_async_commit();
    stage_rows<T, DH>(dst + TK * DH, DH, vpool, pg, i * TK, n, page, hd, h);
    cp_async_commit();
  };
  float m = kNegInf, l = 0.f, acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  fetch(0);
  for (int i = 0; i < ntiles; ++i) {
    fetch(i + 1);         // in flight during this tile's math
    cp_async_wait<3>();   // this tile's K has landed
    __syncthreads();
    const T* ks = ring + (i & 1) * stage;
    const T* vs = ks + TK * DH;
    const int nk = min(TK, nkeys - i * TK);
    for (int base = warp * kKpw; base < nk; base += kWarps * kKpw) {
      const int kk = base + lane / kLpk;
      float part = 0.f;
      if (kk < nk) {
        float kv[kVec];
        load_f32<T, kVec>(kv, ks + (size_t)kk * DH + sub * kVec);
#pragma unroll
        for (int e = 0; e < kVec; ++e) part += qv[e] * kv[e];
      }
      part = group_sum<kLpk>(part);
      if (sub == 0 && kk < nk) sc[kk] = part;
    }
    __syncthreads();
    float tmax = kNegInf;
    for (int kk = tid; kk < nk; kk += kThreads) tmax = fmaxf(tmax, sc[kk]);
    const float m_new = fmaxf(m, block_max(tmax, wred));
    const float corr = expf(m - m_new);
    float tsum = 0.f;
    for (int kk = tid; kk < nk; kk += kThreads) {
      const float p = expf(sc[kk] - m_new);
      sc[kk] = p;
      tsum += p;
    }
    l = l * corr + block_sum(tsum, wred);  // its barrier publishes p
    m = m_new;
    cp_async_wait<2>();   // this tile's V has landed
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= corr;
    for (int kk = g; kk < nk; kk += kGroups) {
      const float p = sc[kk];
      float v[kVec];
      load_f32<T, kVec>(v, vs + (size_t)kk * DH + sub * kVec);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += p * v[e];
    }
    __syncthreads();  // the next tile's loads rewrite this stage and sc
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) red[g * DH + sub * kVec + e] = acc[e];
  __syncthreads();
  float* part = ws_acc + (unit * NS + split) * DH;
  for (int d = tid; d < DH; d += kThreads) {
    float t = 0.f;
    for (int gg = 0; gg < kGroups; ++gg) t += red[gg * DH + d];
    part[d] = t;
  }
  if (tid == 0) {
    ws_ml[(unit * NS + split) * 2] = m;
    ws_ml[(unit * NS + split) * 2 + 1] = l;
  }
}

// K5, one split. Block (head h, split z, row tile y) takes query rows
// [16y, 16y + 16) of the chunk against the span's keys below L. Thread
// (r, j) owns row r's softmax state and the j-th eighth of its Dh.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_prefill_split_kernel(const T* __restrict__ q,
                           const T* __restrict__ kpool,
                           const T* __restrict__ vpool,
                           const int* __restrict__ bt,
                           float* __restrict__ ws_acc,
                           float* __restrict__ ws_ml, int C, int H, int page,
                           int MP, int NS, int TK, int t0, int L,
                           float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kKs = DH + kVec;           // Q and K row stride: 16 B pad
  constexpr int kTpr = kThreads / kRows;   // 8 threads per query row
  constexpr int kDs = DH / kTpr;           // the slice of Dh each owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage = TK * (kKs + DH);
  T* ring = reinterpret_cast<T*>(smem_raw);  // [2][K: TK x kKs, V: TK x DH]
  T* qs = ring + 2 * stage;                  // [kRows][kKs]
  float* sc = reinterpret_cast<float*>(qs + kRows * kKs);  // [kRows][scs]
  const int scs = TK + 8;
  int* pg = reinterpret_cast<int*>(sc + kRows * scs);  // [kSplitPages]

  const int h = blockIdx.x, split = blockIdx.y, r0 = blockIdx.z * kRows;
  const int span = kSplitPages * page, k0 = split * span;
  if (k0 >= L) return;
  const int nkeys = min(span, L - k0);
  const int ntiles = (nkeys + TK - 1) / TK;
  const int tid = threadIdx.x;
  const size_t hd = (size_t)H * DH;
  if (tid < kSplitPages && split * kSplitPages + tid < MP)
    pg[tid] = bt[split * kSplitPages + tid];
  for (int i = tid; i < kRows * kKs; i += kThreads) {
    const int r = i / kKs, d = i - r * kKs;
    qs[i] = (r0 + r < C && d < DH)
                ? q[(size_t)(r0 + r) * hd + (size_t)h * DH + d]
                : from_f32<T>(0.f);
  }
  __syncthreads();  // pg, qs

  auto fetch = [&](int i) {  // tile i's K and V: two commit groups
    T* dst = ring + (i & 1) * stage;
    const int n = i < ntiles ? min(TK, nkeys - i * TK) : 0;
    stage_rows<T, DH>(dst, kKs, kpool, pg, i * TK, n, page, hd, h);
    cp_async_commit();
    stage_rows<T, DH>(dst + TK * kKs, DH, vpool, pg, i * TK, n, page, hd, h);
    cp_async_commit();
  };
  fetch(0);
  const int r = tid / kTpr, j = tid % kTpr;
  const int q_pos = t0 + r0 + r;
  float m = kNegInf, l = 0.f, acc[kDs];
#pragma unroll
  for (int e = 0; e < kDs; ++e) acc[e] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    fetch(i + 1);
    cp_async_wait<3>();
    __syncthreads();
    const T* ks = ring + (i & 1) * stage;
    const T* vs = ks + TK * kKs;
    const int kb = k0 + i * TK;  // position of the tile's key 0
    const int nk = min(TK, nkeys - i * TK);
    // one (row, key) dot product per thread and step, fp32 FMAs in Dh
    // order; the padded K rows put neighbouring threads' 16-byte loads on
    // different banks
    for (int p = tid; p < kRows * TK; p += kThreads) {
      const int row = p / TK, kk = p - row * TK;
      float dot = 0.f;
      if (kk < nk) {
#pragma unroll
        for (int d = 0; d < DH; d += kVec) {
          float a[kVec], b[kVec];
          load_f32<T, kVec>(a, qs + row * kKs + d);
          load_f32<T, kVec>(b, ks + (size_t)kk * kKs + d);
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot += a[e] * b[e];
        }
      }
      sc[row * scs + kk] =
          (kk < nk && t0 + r0 + row >= kb + kk) ? dot * scale : kNegInf;
    }
    __syncthreads();
    // row r's online softmax over this tile, shared by its 8 threads
    float* sr = sc + r * scs;
    float tmax = kNegInf;
    for (int kk = j; kk < nk; kk += kTpr) tmax = fmaxf(tmax, sr[kk]);
    const float m_new = fmaxf(m, group_max<kTpr>(tmax));
    const float corr = expf(m - m_new);
    float tsum = 0.f;
    for (int kk = j; kk < nk; kk += kTpr) {
      const float p = q_pos >= kb + kk ? expf(sr[kk] - m_new) : 0.f;
      sr[kk] = p;
      tsum += p;
    }
    l = l * corr + group_sum<kTpr>(tsum);
    m = m_new;
    cp_async_wait<2>();
    __syncthreads();  // V has landed; row r's p is visible to its threads
#pragma unroll
    for (int e = 0; e < kDs; ++e) acc[e] *= corr;
    for (int kk = 0; kk < nk; ++kk) {
      const float p = sr[kk];
      float v[kDs];
      load_f32<T, kDs>(v, vs + (size_t)kk * DH + j * kDs);
#pragma unroll
      for (int e = 0; e < kDs; ++e) acc[e] += p * v[e];
    }
    __syncthreads();
  }
  if (r0 + r < C) {
    const size_t at = ((size_t)(r0 + r) * H + h) * NS + split;
#pragma unroll
    for (int e = 0; e < kDs; ++e) ws_acc[at * DH + j * kDs + e] = acc[e];
    if (j == 0) {
      ws_ml[at * 2] = m;
      ws_ml[at * 2 + 1] = l;
    }
  }
}

// The combine: one warp per output row u (a (slot, head) of decode, a
// (row, head) of prefill) merges its live splits in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_ml,
                     const int* __restrict__ seq_lens, int L,
                     T* __restrict__ out, float* __restrict__ lse, int U,
                     int H, int Dh, int NS, int span, int max_keys) {
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= U) return;
  const int len = seq_lens != nullptr ? min(seq_lens[u / H], max_keys) : L;
  const int n = (len + span - 1) / span;  // live splits
  const float* ml = ws_ml + (size_t)u * NS * 2;
  float mx = kNegInf;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < n; ++i) l += ml[2 * i + 1] * expf(ml[2 * i] - mx);
  const float den = l == 0.f ? 1.f : l;
  for (int d = lane; d < Dh; d += 32) {
    float a = 0.f;
    for (int i = 0; i < n; ++i)
      a += ws_acc[((size_t)u * NS + i) * Dh + d] * expf(ml[2 * i] - mx);
    out[(size_t)u * Dh + d] = from_f32<T>(a / den);
  }
  if (lse != nullptr && lane == 0)
    lse[u] = l > 0.f ? mx + logf(l) : kLseEmpty;
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

size_t decode_shared(int tk, int Dh, size_t item) {
  const int groups = kThreads / (Dh / (int)(16 / item));
  return 4 * (size_t)tk * Dh * item
         + (size_t)(tk + groups * Dh + kWarps) * sizeof(float)
         + kSplitPages * sizeof(int);
}

size_t prefill_shared(int tk, int Dh, size_t item) {
  const size_t ks = Dh + 16 / item;
  return 2 * (size_t)tk * (ks + Dh) * item + kRows * ks * item
         + (size_t)kRows * (tk + 8) * sizeof(float)
         + kSplitPages * sizeof(int);
}

// Keys per ring tile: the span rounded up to a power of two, at most 128
// (decode) or 64 (prefill, at least 16), halved until the tiles fit 48 KB.
int decode_tile(int span, int Dh, size_t item) {
  int tk = next_pow2(span) < 128 ? next_pow2(span) : 128;
  while (tk > 1 && decode_shared(tk, Dh, item) > kMaxShared) tk >>= 1;
  return tk;
}

int prefill_tile(int span, int Dh, size_t item) {
  int tk = next_pow2(span);
  tk = tk < 16 ? 16 : (tk > 64 ? 64 : tk);
  while (tk > 16 && prefill_shared(tk, Dh, item) > kMaxShared) tk >>= 1;
  return tk;
}

template <typename K>
int allow_shared(K* kernel, size_t shm) {
  if (shm <= kMaxShared) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
}

// Dh is a template parameter: the head widths the port serves and tests.
#define DL4J_DH_SWITCH(Dh, ...)                   \
  switch (Dh) {                                   \
    case 8: { constexpr int DH = 8; __VA_ARGS__; } break;     \
    case 16: { constexpr int DH = 16; __VA_ARGS__; } break;   \
    case 32: { constexpr int DH = 32; __VA_ARGS__; } break;   \
    case 64: { constexpr int DH = 64; __VA_ARGS__; } break;   \
    case 128: { constexpr int DH = 128; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;   \
  }

int splits(int MP) { return (MP + kSplitPages - 1) / kSplitPages; }

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* bt, const void* sl, void* ws, void* out,
                  void* lse, int S, int H, int Dh, int page, int MP,
                  float scale, void* stream) {
  const int span = kSplitPages * page, NS = splits(MP);
  const int tk = decode_tile(span, Dh, sizeof(T));
  const size_t shm = decode_shared(tk, Dh, sizeof(T));
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)S * H * NS * Dh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DL4J_DH_SWITCH(Dh, {
    const int err = allow_shared(paged_decode_split_kernel<T, DH>, shm);
    if (err != 0) return err;
    paged_decode_split_kernel<T, DH><<<dim3(S, H, NS), kThreads, shm, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(bt),
        static_cast<const int*>(sl), ws_acc, ws_ml, H, page, MP, NS, tk,
        scale);
  })
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int U = S * H;
  paged_combine_kernel<T><<<(U + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      ws_acc, ws_ml, static_cast<const int*>(sl), 0, static_cast<T*>(out),
      static_cast<float*>(lse), U, H, Dh, NS, span, MP * page);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prefill(const void* q, const void* k, const void* v,
                   const void* bt, void* ws, void* out, int C, int H, int Dh,
                   int page, int MP, int t0, int n_valid, float scale,
                   void* stream) {
  const int span = kSplitPages * page, NS = splits(MP);
  const int tk = prefill_tile(span, Dh, sizeof(T));
  const size_t shm = prefill_shared(tk, Dh, sizeof(T));
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)C * H * NS * Dh;
  const int L = t0 + n_valid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, NS, (C + kRows - 1) / kRows);
  DL4J_DH_SWITCH(Dh, {
    const int err = allow_shared(paged_prefill_split_kernel<T, DH>, shm);
    if (err != 0) return err;
    paged_prefill_split_kernel<T, DH><<<grid, kThreads, shm, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(bt), ws_acc,
        ws_ml, C, H, page, MP, NS, tk, t0, L, scale);
  })
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int U = C * H;
  paged_combine_kernel<T><<<(U + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      ws_acc, ws_ml, nullptr, L, static_cast<T*>(out), nullptr, U, H, Dh,
      NS, span, MP * page);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface ops/_kernels.py binds with ctypes. Each launches the
// split kernel and the combine on `stream` and returns cudaGetLastError()
// after them (0 = launched), or cudaErrorInvalidValue for a head width
// with no instantiation. `ws` is the fp32 workspace of the layout above,
// U * NS * (Dh + 2) floats; ops/paged_attention.py sizes it.
extern "C" {

int dl4j_paged_decode_f32(const void* q, const void* k, const void* v,
                          const void* bt, const void* sl, void* ws,
                          void* out, void* lse, int S, int H, int Dh,
                          int page, int MP, float scale, void* stream) {
  return launch_decode<float>(q, k, v, bt, sl, ws, out, lse, S, H, Dh, page,
                              MP, scale, stream);
}

int dl4j_paged_decode_bf16(const void* q, const void* k, const void* v,
                           const void* bt, const void* sl, void* ws,
                           void* out, void* lse, int S, int H, int Dh,
                           int page, int MP, float scale, void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, bt, sl, ws, out, lse, S, H,
                                      Dh, page, MP, scale, stream);
}

int dl4j_paged_prefill_f32(const void* q, const void* k, const void* v,
                           const void* bt, void* ws, void* out, int C, int H,
                           int Dh, int page, int MP, int t0, int n_valid,
                           float scale, void* stream) {
  return launch_prefill<float>(q, k, v, bt, ws, out, C, H, Dh, page, MP, t0,
                               n_valid, scale, stream);
}

int dl4j_paged_prefill_bf16(const void* q, const void* k, const void* v,
                            const void* bt, void* ws, void* out, int C,
                            int H, int Dh, int page, int MP, int t0,
                            int n_valid, float scale, void* stream) {
  return launch_prefill<__nv_bfloat16>(q, k, v, bt, ws, out, C, H, Dh, page,
                                       MP, t0, n_valid, scale, stream);
}

}  // extern "C"
