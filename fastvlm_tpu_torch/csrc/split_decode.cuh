// The split and merge passes of kernel K3 (csrc/paged_decode_attention.cu):
// split-sequence flash decoding, one block per (split of SPLIT = 64 keys,
// KV head, row) that writes an unnormalised f32 partial P.V with its (max,
// sum), and a merge pass of one block per (row, query head). This is the
// device code kernel K2 (csrc/decode_attention.cu) used before it became a
// single launch; K3 keeps it as it was. Semantics: q pre-scaled by D^-0.5 in
// q's dtype; masked keys -1e30; softmax and P.V in f32; the denominator
// floored at 1e-30; query head h reads KV head h / (Hq / Hkv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SPLIT = 64;      // keys per block in pass 1
constexpr int GMAX = 16;       // query heads per KV head
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory of one split block: its K and V rows (words, each row
// padded by one word so that consecutive rows start one bank apart), the
// scaled queries and the scores.
template <typename T, int D>
struct SplitSmem {
  static constexpr int RW = D * (int)sizeof(T) / 4;  // 32-bit words per row
  static constexpr int LD = RW + 1;
  static constexpr int VPR = D * (int)sizeof(T) / 16;  // 16-byte vectors per row
  static constexpr size_t k = 0;
  static constexpr size_t v = k + SPLIT * LD;          // in words
  static constexpr size_t q = v + SPLIT * LD;
  static constexpr size_t sc = q + GMAX * D;
  static constexpr size_t bytes = (sc + GMAX * SPLIT) * 4;
};

// Pass 1 of one (split, KV head, row) block, shared with kernel K3
// (csrc/paged_decode_attention.cu), which differs only in where a key row
// lies: `row_off(j)` is the element offset in k and v of the split's key
// row j (0 <= j < nvalid). head0 = b * Hq + kvh * G is the block's first
// query head. part_acc: (B, Hq, n_split, D) f32; part_ml: (B, Hq, n_split,
// 2) f32.
template <typename T, int D, typename RowOff>
__device__ __forceinline__ void split_pass(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    RowOff row_off, int nvalid, size_t head0, int g_count, int split,
    int n_split, float* __restrict__ part_acc, float* __restrict__ part_ml,
    float scale) {
  using S = SplitSmem<T, D>;
  const int tid = threadIdx.x;

  if (nvalid <= 0) {  // wholly past the row's length: zero weight, no reads
    for (int e = tid; e < g_count * D; e += THREADS)
      part_acc[((head0 + e / D) * n_split + split) * D + e % D] = 0.f;
    for (int g = tid; g < g_count; g += THREADS) {
      part_ml[((head0 + g) * n_split + split) * 2] = NEG_INF;
      part_ml[((head0 + g) * n_split + split) * 2 + 1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) float smem[];
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem + S::k);
  uint32_t* vs = reinterpret_cast<uint32_t*>(smem + S::v);
  float* qs = smem + S::q;   // [GMAX][D]
  float* sc = smem + S::sc;  // [GMAX][SPLIT]

  // the split's valid K and V rows, 16 bytes a load, all loads in flight
#pragma unroll 4
  for (int i = tid; i < nvalid * S::VPR; i += THREADS) {
    const int row = i / S::VPR, vi = i % S::VPR;
    const size_t off = row_off(row) + vi * (16 / sizeof(T));
    const uint4 kv4 = *reinterpret_cast<const uint4*>(k + off);
    const uint4 vv4 = *reinterpret_cast<const uint4*>(v + off);
    uint32_t* kd = ks + row * S::LD + vi * 4;
    uint32_t* vd = vs + row * S::LD + vi * 4;
    kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
    vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
  }
  // q * D^-0.5, rounded to q's dtype as the TPU kernel's pre-scale is
  const float scale_t = to_f(from_f<T>(scale));
  for (int e = tid; e < g_count * D; e += THREADS)
    qs[e] = to_f(from_f<T>(to_f(q[head0 * D + e]) * scale_t));
  __syncthreads();

  // scores: thread (j, g-half) dots its key row with its heads' queries
  constexpr int G_PER = THREADS / SPLIT;
  {
    const int j = tid % SPLIT;
    const T* krow = reinterpret_cast<const T*>(ks + j * S::LD);
    for (int g = tid / SPLIT; g < g_count; g += G_PER) {
      float s = NEG_INF;
      if (j < nvalid) {
        s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qs[g * D + d], to_f(krow[d]), s);
      }
      sc[g * SPLIT + j] = s;
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < g_count; g += THREADS / 32) {
    float m = NEG_INF;
    for (int j = lane; j < SPLIT; j += 32) m = fmaxf(m, sc[g * SPLIT + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < SPLIT; j += 32) {
      const float p = expf(sc[g * SPLIT + j] - m);
      sc[g * SPLIT + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_ml[((head0 + g) * n_split + split) * 2] = m;
      part_ml[((head0 + g) * n_split + split) * 2 + 1] = l;
    }
  }
  __syncthreads();

  for (int e = tid; e < g_count * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float acc = 0.f;
    for (int j = 0; j < nvalid; ++j)
      acc = fmaf(sc[g * SPLIT + j],
                 to_f(reinterpret_cast<const T*>(vs + j * S::LD)[d]), acc);
    part_acc[((head0 + g) * n_split + split) * D + d] = acc;
  }
}

// One block per (row, query head), one thread per d.
template <typename T, int D>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
             T* __restrict__ out, int n_split) {
  const size_t h = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + h * n_split * 2;
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - m);
    l = fmaf(ml[2 * s + 1], w, l);
    acc = fmaf(part_acc[(h * n_split + s) * D + d], w, acc);
  }
  out[h * D + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

}  // namespace
