// Kernel K2: decode attention, one query token per row against a dense KV
// cache, written by hand for Hopper (sm_90a) as split-sequence flash
// decoding.
//
// Replaces: fastvlm_tpu/ops/pallas/decode_attention.py::decode_attention
// (Pallas, TPU). Same semantics: q is pre-scaled by D^-0.5 in q's dtype;
// keys at index >= lengths[b] are masked with -1e30; softmax and the P.V
// sum in f32; the denominator floored at 1e-30; output in q's dtype.
// GQA: query head h reads KV head h / (Hq / Hkv).
//
// What bounds it on this card: device-memory bytes. Each step reads every
// valid key and value once (2 * len * Hkv * D elements) and does ~4 FLOPs
// per element read, far below the ~295 FLOPs/byte ridge. At the 0.5B
// geometry a row's cache is a few hundred KB per layer, so the real limit
// is how many SMs share the read: B * Hkv is only 2 at 0.5B batch 1.
//
// Design:
//  * Pass 1: one block per (sequence split of SPLIT = 64 keys, KV head,
//    row). It copies its valid K and V rows into shared memory with every
//    load in flight at once, holds the G = Hq/Hkv scaled query heads of its
//    KV head there too, scores its keys (one thread per key and head group),
//    takes the split's max and exp-sum per head, and writes an
//    unnormalised f32 partial P.V with its (max, sum). Splits wholly past
//    lengths[b] write zero weight without reading K or V (the TPU kernel read
//    and masked every block; the result is the same).
//  * Pass 2: one block per (row, query head) merges the splits with the
//    usual rescaling by exp(m_split - m_max). An empty split carries
//    m = -1e30 and sum 0, so it merges with weight 0, never NaN.
//  * The TPU kernel's block-diagonal lane embedding of the GQA queries was a
//    VMEM tiling device and is not carried over.
//  Requires lengths[b] >= 1 (the caller counts the token just written).
//  Pass 1's body (split_pass) and pass 2 are shared with kernel K3, the
//  paged variant, which includes this file (csrc/paged_decode_attention.cu).

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

// q: (B, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) int32.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             int hq, int hkv, int s_max, int n_split, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g_count = hq / hkv;
  const int len = min(lengths[b], s_max);
  const int s0 = split * SPLIT;
  const size_t row_stride = (size_t)hkv * D;
  const size_t base = ((size_t)b * s_max + s0) * row_stride + (size_t)kvh * D;
  split_pass<T, D>(q, k, v, [=](int j) { return base + j * row_stride; },
                   min(SPLIT, len - s0), (size_t)b * hq + (size_t)kvh * g_count,
                   g_count, split, n_split, part_acc, part_ml, scale);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* part_acc, void* part_ml, void* out, int b, int hq, int hkv,
                   int s_max, int n_split, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const size_t bytes = SplitSmem<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  split_kernel<T, D><<<dim3(n_split, hkv, b), THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths,
      (float*)part_acc, (float*)part_ml, hq, hkv, s_max, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T, D><<<b * hq, D, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml, (T*)out, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     const void* lengths, void* part_acc, void* part_ml, void* out,
                     int b, int hq, int hkv, int s_max, int n_split, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, lengths, part_acc, part_ml, out, b, hq, hkv, s_max, n_split, s);
    case 64: return launch<T, 64>(q, k, v, lengths, part_acc, part_ml, out, b, hq, hkv, s_max, n_split, s);
    case 128: return launch<T, 128>(q, k, v, lengths, part_acc, part_ml, out, b, hq, hkv, s_max, n_split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fvlm_decode_split(void) { return SPLIT; }

// dtype: 0 float32, 1 bfloat16; head_dim d: 16, 64 or 128. Launches both
// passes on `stream`
// and returns the CUDA error code of the launches.
int fvlm_decode_attention(const void* q, const void* k, const void* v,
                          const void* lengths, void* part_acc, void* part_ml,
                          void* out, int b, int hq, int hkv, int d, int s_max,
                          int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > GMAX) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(d, q, k, v, lengths, part_acc, part_ml, out, b, hq, hkv, s_max, n_split, s); break;
    case 1: err = dispatch<__nv_bfloat16>(d, q, k, v, lengths, part_acc, part_ml, out, b, hq, hkv, s_max, n_split, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
