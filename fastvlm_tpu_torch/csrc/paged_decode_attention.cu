// Kernel K3: paged decode attention, one query token per row against a KV
// page pool read in place through block tables, written by hand for Hopper
// (sm_90a).
//
// Replaces: fastvlm_tpu/ops/pallas/decode_attention.py::paged_decode_attention
// (Pallas, TPU). Same semantics as K2 (csrc/decode_attention.cu): q is
// pre-scaled by D^-0.5 in q's dtype; keys at virtual position >= lengths[b]
// are masked with -1e30; softmax and the P.V sum in f32; the denominator
// floored at 1e-30; output in q's dtype; query head h reads KV head
// h / (Hq / Hkv). Virtual position t of row b lives at pool page
// block_tables[b, t / page], slot t % page; an unmapped entry (-1) clamps
// to page 0 and is masked by the length, as the TPU kernel's index map
// does. Positions past the table's capacity (pages_per_seq * page) do not
// exist: the length is cut there, as the TPU kernel's grid is.
//
// What bounds it on this card: device-memory bytes, as K2 (each step reads
// every valid key and value once, ~4 FLOPs an element). On top of K2, each
// key row costs one block-table read, which the split does once per row
// into shared memory.
//
// Design: K2's two passes with paged addressing.
//  * Pass 1: one block per (split of SPLIT = 64 virtual positions, KV head,
//    row). Its threads look up the pool row of each valid position
//    (page id from the table, clamped to [0, num_pages)) into shared
//    memory once, then run K2's split body (split_pass): 16-byte loads of
//    the K/V rows, scores, the split's max and exp-sum, an unnormalised f32
//    partial P.V. A split spans 64 / page pages (page 8-64) or half a page
//    (page 128). Splits past the row's length write zero weight without
//    reading, so a table as wide as the pool costs empty blocks only; the
//    serving scheduler passes tables cut to its page watermark.
//  * Pass 2: K2's merge, one block per (row, query head).
//  Pad and finished rows (table all -1, any length) read page 0 and give a
//  finite output. Requires lengths[b] >= 1.
//
// The split body (split_pass) and the merge pass are in split_decode.cuh,
// the device code K2 shared with this kernel before K2 became one launch.

#include "split_decode.cuh"

namespace {

// q: (B, Hq, D); k_pages, v_pages: (num_pages, page, Hkv, D);
// block_tables: (B, pages_per_seq) int32; lengths: (B,) int32.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int hq, int hkv, int page, int pages_per_seq,
                   int num_pages, int n_split, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g_count = hq / hkv;
  const int len = min(lengths[b], pages_per_seq * page);
  const int s0 = split * SPLIT;
  const int nvalid = min(SPLIT, len - s0);

  // pool row (page * page_size + slot) of each valid position of the split
  __shared__ int pool_row[SPLIT];
  if ((int)threadIdx.x < nvalid) {
    const int pos = s0 + threadIdx.x;
    int pid = block_tables[(size_t)b * pages_per_seq + pos / page];
    pid = min(max(pid, 0), num_pages - 1);
    pool_row[threadIdx.x] = pid * page + pos % page;
  }
  __syncthreads();

  const size_t row_stride = (size_t)hkv * D;
  const size_t head_off = (size_t)kvh * D;
  const int* rows = pool_row;
  split_pass<T, D>(q, k_pages, v_pages,
                   [=](int j) { return (size_t)rows[j] * row_stride + head_off; },
                   nvalid, (size_t)b * hq + (size_t)kvh * g_count, g_count,
                   split, n_split, part_acc, part_ml, scale);
}

template <typename T, int D>
cudaError_t paged_launch(const void* q, const void* k_pages, const void* v_pages,
                         const void* block_tables, const void* lengths,
                         void* part_acc, void* part_ml, void* out, int b, int hq,
                         int hkv, int page, int pages_per_seq, int num_pages,
                         int n_split, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const size_t bytes = SplitSmem<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  paged_split_kernel<T, D><<<dim3(n_split, hkv, b), THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages,
      (const int*)block_tables, (const int*)lengths, (float*)part_acc,
      (float*)part_ml, hq, hkv, page, pages_per_seq, num_pages, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T, D><<<b * hq, D, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml, (T*)out, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t paged_dispatch(int d, const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, void* part_acc, void* part_ml,
                           void* out, int b, int hq, int hkv, int page,
                           int pages_per_seq, int num_pages, int n_split,
                           cudaStream_t s) {
  switch (d) {
    case 16: return paged_launch<T, 16>(q, k_pages, v_pages, block_tables, lengths, part_acc, part_ml, out, b, hq, hkv, page, pages_per_seq, num_pages, n_split, s);
    case 64: return paged_launch<T, 64>(q, k_pages, v_pages, block_tables, lengths, part_acc, part_ml, out, b, hq, hkv, page, pages_per_seq, num_pages, n_split, s);
    case 128: return paged_launch<T, 128>(q, k_pages, v_pages, block_tables, lengths, part_acc, part_ml, out, b, hq, hkv, page, pages_per_seq, num_pages, n_split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fvlm_decode_split(void) { return SPLIT; }

// dtype: 0 float32, 1 bfloat16; head_dim d: 16, 64 or 128; page >= 1.
// Launches both passes on `stream` and returns the CUDA error code of the
// launches.
int fvlm_paged_decode_attention(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* part_acc,
                                void* part_ml, void* out, int b, int hq,
                                int hkv, int d, int page, int pages_per_seq,
                                int num_pages, int n_split, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > GMAX || page <= 0 ||
      pages_per_seq <= 0 || num_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype) {
    case 0: err = paged_dispatch<float>(d, q, k_pages, v_pages, block_tables, lengths, part_acc, part_ml, out, b, hq, hkv, page, pages_per_seq, num_pages, n_split, s); break;
    case 1: err = paged_dispatch<__nv_bfloat16>(d, q, k_pages, v_pages, block_tables, lengths, part_acc, part_ml, out, b, hq, hkv, page, pages_per_seq, num_pages, n_split, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
