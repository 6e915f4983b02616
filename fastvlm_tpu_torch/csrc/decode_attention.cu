// Kernel K2: decode attention, one query token per row against a dense KV
// cache, written by hand for Hopper (sm_90a) as one-launch flash decoding.
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
// geometry and batch 1 that is ~200 KB a layer: 0.06 us at 3.35 TB/s, so
// what a call really costs is latency: the launch, one trip to device
// memory, and the merge of the splits.
//
// Design: the one-launch body of csrc/decode_body.cuh (clusters of 8
// blocks merged through distributed shared memory, mma.sync, the last
// block merging a row's splits), which kernel K3 shares. Here a key's rows
// lie at row (b, key) of the dense cache (DenseRows).
//  * The TPU kernel's block-diagonal lane embedding of the GQA queries was a
//    VMEM tiling device and is not carried over.
//  Requires lengths[b] >= 1 (the caller counts the token just written).

#include "decode_body.cuh"

namespace {

// Row (b, key) of a dense cache, KV head kvh: base = (b * S_max * Hkv + kvh)
// * D, stride = Hkv * D elements a key.
struct DenseRows {
  size_t base, stride;
  using Tile = size_t;  // the offset of the warp's first key
  __device__ __forceinline__ Tile tile(int key0, int) const { return base + key0 * stride; }
  __device__ __forceinline__ size_t off(Tile t, int r) const { return t + r * stride; }
};

// K2: q: (B, Hq, D); k, v: (B, S_max, Hkv, D) dense caches; lengths: (B,)
// int32. Grid and workspace as decode_body.
template <typename T, int D>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(Smem<T, D>::THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int* __restrict__ counters, T* __restrict__ out,
              int hq, int hkv, int s_max, int split, float scale) {
  const size_t row_stride = (size_t)hkv * D;
  const DenseRows rows{(size_t)blockIdx.z * s_max * row_stride + (size_t)blockIdx.y * D,
                       row_stride};
  decode_body<T, D>(q, k, v, rows, lengths + blockIdx.z, s_max, part_acc, part_ml, counters,
                    out, hq, hkv, split, scale, 0);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   float* part_acc, float* part_ml, int* counters, void* out, int b, int hq,
                   int hkv, int s_max, cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T, D>::BYTES);
  if (attr != cudaSuccess) return attr;
  const int split = pick_split(b, hkv, s_max, Smem<T, D>::TILE);
  const int n_split = (s_max + split - 1) / split;
  decode_kernel<T, D><<<dim3(n_split * CL, hkv, b), Smem<T, D>::THREADS,
                        Smem<T, D>::BYTES, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, part_acc, part_ml,
      counters, (T*)out, hq, hkv, s_max, split, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* lengths,
                     float* part_acc, float* part_ml, int* counters, void* out, int b, int hq,
                     int hkv, int s_max, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, lengths, part_acc, part_ml, counters, out, b, hq, hkv, s_max, s);
    case 64: return launch<T, 64>(q, k, v, lengths, part_acc, part_ml, counters, out, b, hq, hkv, s_max, s);
    case 128: return launch<T, 128>(q, k, v, lengths, part_acc, part_ml, counters, out, b, hq, hkv, s_max, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Keys per split block for this shape (0: a shape the kernel does not take).
int fvlm_decode_split(int b, int hkv, int d, int s_max, int dtype) {
  const int tile = block_tile(dtype, d);
  return tile ? pick_split(b, hkv, s_max, tile) : 0;
}

// f32 elements of workspace fvlm_decode_attention needs: the splits'
// partial P.V (B, Hkv, n_split, G, D), then their (max, sum) pairs.
long long fvlm_decode_workspace(int b, int hq, int hkv, int d, int s_max, int dtype) {
  const int split = fvlm_decode_split(b, hkv, d, s_max, dtype);
  if (split == 0) return 0;
  const long long n_split = (s_max + split - 1) / split;
  return (long long)b * hq * n_split * (d + 2);
}

// dtype: 0 float32, 1 bfloat16; head_dim d: 16, 64 or 128. workspace:
// fvlm_decode_workspace(...) f32 elements; counters: B * Hkv int32, zero
// (the kernel leaves them zero). One launch on `stream`; returns its CUDA
// error code.
int fvlm_decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                          void* workspace, void* counters, void* out, int b, int hq, int hkv,
                          int d, int s_max, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > GMAX || s_max <= 0)
    return (int)cudaErrorInvalidValue;
  const int split = fvlm_decode_split(b, hkv, d, s_max, dtype);
  if (split == 0) return (int)cudaErrorInvalidValue;
  const size_t n_split = (s_max + split - 1) / split;
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml = part_acc + (size_t)b * hq * n_split * d;
  int* cnt = static_cast<int*>(counters);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(d, q, k, v, lengths, part_acc, part_ml, cnt, out, b, hq, hkv, s_max, s); break;
    case 1: err = dispatch<__nv_bfloat16>(d, q, k, v, lengths, part_acc, part_ml, cnt, out, b, hq, hkv, s_max, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
