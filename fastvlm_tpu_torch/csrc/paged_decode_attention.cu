// Kernel K3: paged decode attention, one query token per row against a KV
// page pool read in place through block tables, written by hand for Hopper
// (sm_90a) as one-launch flash decoding.
//
// Replaces: fastvlm_tpu/ops/pallas/decode_attention.py::paged_decode_attention
// (Pallas, TPU). Same semantics as K2 (csrc/decode_attention.cu): q is
// pre-scaled by D^-0.5 in q's dtype; keys at virtual position >= lengths[b]
// are masked with -1e30; softmax and the P.V sum in f32; the denominator
// floored at 1e-30; output in q's dtype; query head h reads KV head
// h / (Hq / Hkv). Virtual position t of row b lives at pool row
// clamp(block_tables[b, t / page], 0, P - 1) * page + t % page: an unmapped
// entry (-1) reads page 0 and is masked by the length, as the TPU kernel's
// index map does. Positions past the table's capacity (pages_per_seq *
// page) do not exist: the length is cut there, as the TPU kernel's grid is.
//
// What bounds it on this card: device-memory bytes, as K2 (each step reads
// every valid key and value once, ~4 FLOPs an element), plus one table
// entry a page. At the serving call (batch 8, 0.5B heads, ~500 keys a row)
// that is ~2 MB, 0.6 us at 3.35 TB/s: what a call costs is latency, the
// launch and the chain of dependent trips to memory (table, then rows).
//
// Design: K2's one-launch body (csrc/decode_body.cuh: clusters of 8 blocks
// merged through distributed shared memory, mma.sync, the last block
// merging a row's splits) with the rows addressed through the block table
// (PagedRows). A warp's 16 keys start at a multiple of 16, so at page >= 16
// they lie in one page and the warp reads one table entry a tile (page 8:
// two). Every lane reads the same entry (one request a warp), for the first
// two tiles together with the length and for each later tile while the
// tile before it computes, so one table trip stands in front of the first
// copies and none in front of the rest. Offsets are size_t (a 7B pool
// holds millions of rows of Hkv * D elements). Tiles prefetched past the
// length read table entries of -1, which clamp to page 0 (valid memory);
// K2's zeroing of V rows past the length keeps them out of the sums, so pad
// rows (table all -1) stay finite. Requires lengths[b] >= 1.
//
// A window W > 0 (a sliding-window layer) masks the keys below lengths[b] -
// W, and each warp walks only the pages that hold a key inside it: their
// table entries are the only ones read after the two prefetched tiles.

#include "decode_body.cuh"

namespace {

// Rows of one (row, KV head) in a pool (P, page, Hkv, D) read through the
// row's block table (pages_per_seq entries). page = 1 << shift.
struct PagedRows {
  const int* table;
  size_t stride, head;  // Hkv * D elements a pool row; kvh * D
  int shift, num_pages;
  struct Tile {
    size_t lo, hi;  // offsets of keys key0 and key0 + KT / 2
  };
  __device__ __forceinline__ size_t row(int page_id, int key) const {
    page_id = min(max(page_id, 0), num_pages - 1);
    return (((size_t)page_id << shift) + (key & ((1 << shift) - 1))) * stride + head;
  }
  __device__ __forceinline__ Tile tile(int key0, int kvalid) const {
    const int p = __ldg(table + (key0 >> shift));
    // page 8: keys key0 + 8 .. key0 + 15 lie on the next entry's page
    constexpr int H = KT / 2;
    const int ph = (1 << shift) < KT && key0 + H < kvalid ? __ldg(table + ((key0 + H) >> shift))
                                                           : p;
    return {row(p, key0), row(ph, key0 + H)};
  }
  __device__ __forceinline__ size_t off(const Tile& t, int r) const {
    return r < KT / 2 ? t.lo + r * stride : t.hi + (r - KT / 2) * stride;
  }
};

// q: (B, Hq, D); k_pages, v_pages: (P, page, Hkv, D); block_tables: (B,
// pages_per_seq) int32; lengths: (B,) int32. Grid and workspace as
// decode_body, over s_cap = pages_per_seq * page positions.
template <typename T, int D>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(Smem<T, D>::THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ counters,
                    T* __restrict__ out, int hq, int hkv, int shift, int pages_per_seq,
                    int num_pages, int split, float scale, int window) {
  const PagedRows rows{block_tables + (size_t)blockIdx.z * pages_per_seq, (size_t)hkv * D,
                       (size_t)blockIdx.y * D, shift, num_pages};
  decode_body<T, D>(q, k_pages, v_pages, rows, lengths + blockIdx.z, pages_per_seq << shift,
                    part_acc, part_ml, counters, out, hq, hkv, split, scale, window);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lengths, float* part_acc,
                   float* part_ml, int* counters, void* out, int b, int hq, int hkv, int shift,
                   int pages_per_seq, int num_pages, int window, cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<T, D>::BYTES);
  if (attr != cudaSuccess) return attr;
  const int s_cap = pages_per_seq << shift;
  const int split = pick_split(b, hkv, s_cap, Smem<T, D>::TILE);
  const int n_split = (s_cap + split - 1) / split;
  paged_decode_kernel<T, D><<<dim3(n_split * CL, hkv, b), Smem<T, D>::THREADS,
                              Smem<T, D>::BYTES, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, (const int*)block_tables,
      (const int*)lengths, part_acc, part_ml, counters, (T*)out, hq, hkv, shift,
      pages_per_seq, num_pages, split, 1.0f / sqrtf((float)D), window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* kp, const void* vp, const void* bt,
                     const void* lengths, float* part_acc, float* part_ml, int* counters,
                     void* out, int b, int hq, int hkv, int shift, int pps, int num_pages,
                     int window, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, kp, vp, bt, lengths, part_acc, part_ml, counters, out, b, hq, hkv, shift, pps, num_pages, window, s);
    case 64: return launch<T, 64>(q, kp, vp, bt, lengths, part_acc, part_ml, counters, out, b, hq, hkv, shift, pps, num_pages, window, s);
    case 128: return launch<T, 128>(q, kp, vp, bt, lengths, part_acc, part_ml, counters, out, b, hq, hkv, shift, pps, num_pages, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Keys per split for this shape, s_cap = pages_per_seq * page (0: a shape
// the kernel does not take).
int fvlm_paged_decode_split(int b, int hkv, int d, int s_cap, int dtype) {
  const int tile = block_tile(dtype, d);
  return tile ? pick_split(b, hkv, s_cap, tile) : 0;
}

// f32 elements of workspace fvlm_paged_decode_attention needs: the splits'
// partial P.V (B, Hkv, n_split, G, D), then their (max, sum) pairs.
long long fvlm_paged_decode_workspace(int b, int hq, int hkv, int d, int s_cap, int dtype) {
  const int split = fvlm_paged_decode_split(b, hkv, d, s_cap, dtype);
  if (split == 0) return 0;
  const long long n_split = (s_cap + split - 1) / split;
  return (long long)b * hq * n_split * (d + 2);
}

// dtype: 0 float32, 1 bfloat16; head_dim d: 16, 64 or 128; page a power of
// two from 8 to 128. workspace: fvlm_paged_decode_workspace(...) f32
// elements; counters: B * Hkv int32, zero (the kernel leaves them zero);
// window: 0 for none, else W > 0. One launch on `stream`; returns its CUDA
// error code.
int fvlm_paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                const void* block_tables, const void* lengths,
                                void* workspace, void* counters, void* out, int b, int hq,
                                int hkv, int d, int page, int pages_per_seq, int num_pages,
                                int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int shift = 3;
  while (shift < 7 && (1 << shift) != page) ++shift;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > GMAX || (1 << shift) != page ||
      pages_per_seq <= 0 || num_pages <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int s_cap = pages_per_seq * page;
  const int split = fvlm_paged_decode_split(b, hkv, d, s_cap, dtype);
  if (split == 0) return (int)cudaErrorInvalidValue;
  const size_t n_split = (s_cap + split - 1) / split;
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml = part_acc + (size_t)b * hq * n_split * d;
  int* cnt = static_cast<int*>(counters);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(d, q, k_pages, v_pages, block_tables, lengths, part_acc, part_ml, cnt, out, b, hq, hkv, shift, pages_per_seq, num_pages, window, s); break;
    case 1: err = dispatch<__nv_bfloat16>(d, q, k_pages, v_pages, block_tables, lengths, part_acc, part_ml, cnt, out, b, hq, hkv, shift, pages_per_seq, num_pages, window, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
