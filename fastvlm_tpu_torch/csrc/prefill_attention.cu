// Kernel K4: causal GQA attention of a prefill, written by hand for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes the prefill's
// attention in XLA (fastvlm_tpu/models/qwen2.py), and the port computed it
// in plain PyTorch (models/qwen2.py::_attend): f32 products on the CUDA
// cores over the whole (B, Hq, T, S) score square, which went to device
// memory and was rewritten by some ten elementwise passes, the largest
// block of device time of a batched prefill. K4 computes the same function
// under the masks the prefills build, without the square.
//
// Computes, for batch row b, query head h (kv head h / (Hq / Hkv)), query i:
//     out[b, i, h] = softmax_k(q[b, i, h] . k[b, k, kvh] * D^-0.5) @ v[b, :, kvh]
// over the keys k <= offset + i, k < kv_lens[b] (no such limit where
// kv_lens is null), k < S and, under a window W > 0, offset + i - k < W (a
// sliding-window layer). Numerics as _attend's in bf16 / fp16: scores
// from the 16-bit q and k with f32 accumulation, the softmax in f32 (a
// running max and sum), probabilities rounded to the 16-bit type before P.V
// with f32 accumulation, the output rounded once. The one difference: the
// row sum divides after P.V instead of before. A row with no key gets zeros.
//
// What bounds it on this card: 4 * D * Hq * Σ_rows (n * offset + n(n+1)/2)
// operations a layer against q, k, v and the output moved once. At the 1.5B
// decoder's 12/2/128 heads and a burst of 8 rows of ~1330 tokens that is
// ~43 GFLOP (44 us at 989 TFLOP/s) against ~77 MB (23 us at 3.35 TB/s): the
// tensor cores bound it, and only wgmma reaches their rate.
//
// Design:
//  * One block per (q head, batch row, 128-query tile). blockIdx.z counts
//    the query tiles down, so the tiles with the most keys issue first; the
//    heads that share a kv head are neighbouring blocks, so their K / V
//    reads meet in L2.
//  * Two warpgroups of 64 query rows. The block's Q tile stays in shared
//    memory; S = Q K^T runs as wgmma m64n128k16 with both operands in
//    shared memory (K read K-major) into 64 f32 registers a thread.
//  * The softmax runs on those registers: exp2 with scale * log2(e) folded
//    into one FMA, the row max and sum across a quad by shuffles, the
//    running output rescaled in registers. P is rounded to bf16 / fp16 in
//    registers and is the A operand of the P.V wgmma (V read MN-major from
//    shared memory), so neither S nor P touches shared or device memory.
//  * Each iteration issues S(j) and P.V(j - 1) together and waits for S(j)
//    alone: the softmax of tile j runs on the CUDA cores while P.V of tile
//    j - 1 runs on the tensor cores (FlashAttention-3's overlap within a
//    warpgroup); the output is rescaled once P.V(j - 1) is done.
//  * K / V tiles of 128 keys arrive through a ring of STAGES stages of
//    16-byte cp.async copies that every thread issues, into wgmma's
//    128-byte swizzled layout: the tile being computed, the one whose P.V
//    runs under it, and STAGES - 2 landing. Rows past the keys a block
//    needs are zero-filled and never read.
//  * A block walks key tiles only up to min(offset + its last query + 1,
//    kv_len, S); the element mask runs only on the tiles that reach past
//    the keys its first query sees.
//  * Under a window W the walk starts at the tile of the first key its
//    first query sees (offset + q0 - W + 1), so a 128-query block reads at
//    most ceil((W + 127) / 128) + 1 tiles, and the lower element mask runs
//    only on the tiles that hold a key some query of the block no longer
//    sees. W = 0 (no window) walks and masks as before, bit for bit.
//  * q, k and v are (B, T | S, H, D) views with any batch, token and head
//    strides (v is a slice of the fused qkv projection), D contiguous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // queries a block: two warpgroups of 64
constexpr int BN = 128;  // keys a tile
constexpr int THREADS = 256;

template <int D>
struct Cfg {
  // K / V tiles in the ring: the tile an iteration computes, the one
  // before it (its P.V runs during this iteration) and STAGES - 2 landing
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one of K, V
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE;
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(SMEM <= 227 * 1024, "tiles exceed shared memory");
};

// keeps the registers of P, which an in-flight P.V reads, live and in place
// until the wait
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// wgmma m64nNk16, f32 += T * T. wgmma_qk: A and B from shared memory, both
// K-major (S = Q K^T, K stored as rows of keys); the first k-step of a tile
// passes scale_d = 0, which overwrites the accumulators. wgmma_pv: A from
// registers (P), B MN-major (V stored as rows of keys).
template <typename T, int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <typename T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_qk<bf16, 128>(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_qk<__half, 128>(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_pv<bf16, 64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<bf16, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Rows [0, ROWS) of a (rows, D) matrix whose row r starts at src + r * ld
// elements, into the swizzled layout at dst (64-wide column blocks of
// ROWS * 128 bytes; K-major for the Q and K tiles, MN-major for the V tile:
// the same bytes). Rows at or past `valid` are zero-filled without a read.
// The 8 chunks of a 128-byte row go to 8 consecutive threads.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, long long ld, int valid,
                                          int tid) {
  constexpr int CHUNKS = (D / 64) * ROWS * 8;
#pragma unroll 4
  for (int i = tid; i < CHUNKS; i += THREADS) {
    const int c = i % 8, r = (i / 8) % ROWS, kb = i / (ROWS * 8);
    const bool ok = r < valid;
    const uint32_t s = dst + kb * ROWS * 128 + swz(r, c);
    const T* g = src + (ok ? r * ld : 0) + kb * 64 + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g),
                 "r"(ok ? 16 : 0));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
prefill_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ kv_lens,
                         T* __restrict__ out, int t, int s, int hq, int group, int offset,
                         int window, long long qsb, long long qst, long long qsh, long long ksb,
                         long long kst, long long ksh, long long vsb, long long vst,
                         long long vsh, float scale_log2) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_base(smem);
  auto k_s = [&](int j) { return base + C::Q_BYTES + (j % STAGES) * C::STAGE; };
  auto v_s = [&](int j) { return k_s(j) + C::KV_BYTES; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32, quad = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = h / group;
  const int kv_lim = kv_lens == nullptr ? s : min(s, kv_lens[b]);
  const int q_end = min(q0 + BM, t);
  const int n_keys = max(0, min(offset + q_end, kv_lim));  // keys the block reads
  const int nt = (n_keys + BN - 1) / BN;
  const int clear = min(offset + q0 + 1, kv_lim);  // keys every query of it sees
  // under a window: the first key the block's first query sees, and the
  // first key its last query sees (below it, some query masks a key)
  const int k_lo = window > 0 ? max(0, offset + q0 - window + 1) : 0;
  const int lo_clear = window > 0 ? offset + q_end - window : 0;
  const int j0 = min(k_lo / BN, nt);

  const T* kg = k + b * ksb + kvh * ksh;
  const T* vg = v + b * vsb + kvh * vsh;
  load_tile<BM, D>(base, q + b * qsb + q0 * qst + h * qsh, qst, q_end - q0, tid);
  auto load_kv = [&](int j) {
    if (j < nt) {
      const int k0 = j * BN, valid = min(BN, n_keys - k0);
      load_tile<BN, D>(k_s(j), kg + k0 * kst, kst, valid, tid);
      load_tile<BN, D>(v_s(j), vg + k0 * vst, vst, valid, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  load_kv(j0);  // one group with the Q tile
#pragma unroll
  for (int j = 1; j < STAGES - 2; ++j) load_kv(j0 + j);

  float o[D / 2];  // 64 rows x D over the warpgroup's 128 threads
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // this thread's rows of the accumulators: queries row and row + 8
  const int row = q0 + 64 * wg + 16 * warp + lane / 4;
  const int lim[2] = {min(offset + row + 1, kv_lim), min(offset + row + 9, kv_lim)};
  const int low[2] = {offset + row - window + 1, offset + row + 9 - window};
  const uint32_t qa = base + wg * 64 * 128;
  // P of the tile whose P.V is issued next: the accumulator's 8-key groups
  // 2ks and 2ks + 1 are the A fragments of P.V's k-step ks
  uint32_t p[BN / 16][4];
  auto issue_pv = [&](int j) {
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks)
      wgmma_pv<T, D>(o, p[ks], desc_sw128(v_s(j) + ks * 2048, BN * 128));
    wgmma_commit();
  };

  // Iteration j issues S(j) and P.V(j - 1) together; the softmax of S(j)
  // runs on the CUDA cores while P.V(j - 1) runs on the tensor cores.
#pragma unroll 1
  for (int j = j0; j < nt; ++j) {
    cp_async_wait<STAGES - 3>();  // tile j has landed
    fence_async_smem();
    __syncthreads();  // ... for every thread; and P.V(j - 2) is done everywhere
    load_kv(j + STAGES - 2);  // into the stage tile j - 2 used

    float sc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_qk<T, BN>(sc, desc_sw128(qa + (ks / 4) * BM * 128 + (ks % 4) * 32, 16),
                      desc_sw128(k_s(j) + (ks / 4) * BN * 128 + (ks % 4) * 32, 16), ks);
    wgmma_commit();
    if (j > j0) {
      issue_pv(j - 1);
      wgmma_wait<1>();  // S(j) is done
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sc);

    // accumulator element 4c + 2hh + e: row + 8hh, key k0 + 8c + 2quad + e
    const int k0 = j * BN;
    if (k0 + BN > clear) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * c + 2 * quad + e;
          if (key >= lim[0]) sc[4 * c + e] = -INFINITY;
          if (key >= lim[1]) sc[4 * c + 2 + e] = -INFINITY;
        }
    }
    if (window > 0 && k0 < lo_clear) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * c + 2 * quad + e;
          if (key < low[0]) sc[4 * c + e] = -INFINITY;
          if (key < low[1]) sc[4 * c + 2 + e] = -INFINITY;
        }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
    float sub[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      // a row that has seen no key yet keeps -inf: subtract 0, so that
      // exp2 gives 0 and not NaN
      sub[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh] * scale_log2;
      alpha[hh] = exp2f(m_run[hh] * scale_log2 - sub[hh]);
      m_run[hh] = mx[hh];
    }
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * c + e] = exp2f(fmaf(sc[4 * c + e], scale_log2, -sub[e / 2]));
        sum[e / 2] += sc[4 * c + e];
      }

    wgmma_wait<0>();  // P.V(j - 1) is done: o and p are free
    fence_regs(o);
    fence_regs(p);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + sum[hh];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[4 * c] *= alpha[0];
      o[4 * c + 1] *= alpha[0];
      o[4 * c + 2] *= alpha[1];
      o[4 * c + 3] *= alpha[1];
    }
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      p[c / 2][(c % 2) * 2] = pack2<T>(sc[4 * c], sc[4 * c + 1]);
      p[c / 2][(c % 2) * 2 + 1] = pack2<T>(sc[4 * c + 2], sc[4 * c + 3]);
    }
  }
  if (nt > j0) {  // the last tile's P.V
    wgmma_fence();
    issue_pv(nt - 1);
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();  // no copy outlives the block (a block with no key tile)

  // the quad's partial row sums, then out (B, T, Hq, D) = o / l
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row + 8 * hh;
    if (i >= t) continue;
    const float inv = l_run[hh] > 0.f ? 1.f / l_run[hh] : 0.f;
    T* dst = out + (((long long)b * t + i) * hq + h) * D + 2 * quad;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + 8 * c) =
          pack2<T>(o[4 * c + 2 * hh] * inv, o[4 * c + 2 * hh + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_lens, void* out,
                   int b, int t, int s, int hq, int hkv, int offset, int window,
                   const long long* st, cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      prefill_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (attr != cudaSuccess) return attr;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  const dim3 grid(hq, b, (t + BM - 1) / BM);
  prefill_attention_kernel<T, D><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_lens, (T*)out, t, s, hq, hq / hkv, offset,
      window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const int* kv_lens,
                     void* out, int b, int t, int s, int hq, int hkv, int offset, int window,
                     const long long* st, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, kv_lens, out, b, t, s, hq, hkv, offset, window, st, stream);
    case 128: return launch<T, 128>(q, k, v, kv_lens, out, b, t, s, hq, hkv, offset, window, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: (B, T, Hq, D), k / v: (B, S, Hkv, D), each with strides (in elements)
// strides[0..2] (q), [3..5] (k), [6..8] (v) for its first three dims, D
// contiguous, rows 16-byte aligned; kv_lens: (B,) int32 or null; out: (B,
// T, Hq * D) contiguous. dtype: 1 bfloat16, 2 float16; head_dim d: 64 or
// 128; window: 0 for none, else W > 0. One launch on `stream` (none where T
// is 0); returns its CUDA error code.
int fvlm_prefill_attention(const void* q, const void* k, const void* v, const void* kv_lens,
                           void* out, int b, int t, int s, int hq, int hkv, int d, int offset,
                           int window, const long long* strides, int dtype, void* stream) {
  if (b <= 0 || t < 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || offset < 0 || window < 0 ||
      b > 65535 ||
      hq > 65535 || (t + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaError_t err;
  switch (dtype) {
    case 1: err = dispatch<bf16>(d, q, k, v, lens, out, b, t, s, hq, hkv, offset, window, strides, st); break;
    case 2: err = dispatch<__half>(d, q, k, v, lens, out, b, t, s, hq, hkv, offset, window, strides, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
