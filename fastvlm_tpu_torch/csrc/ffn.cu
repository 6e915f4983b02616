// Kernel K1: the fused ConvFFN pointwise half, written by hand for Hopper
// (sm_90a).
//
// Replaces: fastvlm_tpu/ops/pallas/ffn.py::fused_ffn (Pallas, TPU).
// Computes, over N token rows of width C and hidden width Ch = 4C:
//     out = residual + ls * (gelu_erf(t @ W1 + b1) @ W2 + b2)
// with f32 accumulation, exact erf GELU, and the GELU output rounded to the
// input dtype before fc2, as the Pallas kernel does. ls may be null (the
// layer scale folded into W2/b2), which skips the multiply. The epilogue
// residual + ls * (acc + b2) is f32, rounded once.
//
// What bounds it on this card: each call does 4*N*C*Ch = 16*N*C^2 FLOPs
// (9.66 GFLOP at every FastViTHD stage of a 1024 px image, 9.77 us at 989
// TFLOP/s). The first stage (C = 96) and the last (C = 1536, mostly weight
// bytes) sit just below the ~295 FLOPs/byte ridge and are bound by bytes
// (11.3 and 12.0 us at 3.35 TB/s); stages 1-3 by the tensor cores. Only
// wgmma reaches the tensor cores' full rate on Hopper.
//
// Design (bf16):
//  * Both products run on wgmma (m64nNk16, bf16 in, f32 accumulate) issued
//    by 128-thread warpgroups, each owning 64 token rows. Operand tiles
//    live in shared memory in wgmma's 128-byte swizzled layout. The weights
//    are row-major (C, Ch) and (Ch, C): wgmma reads them as MN-major B
//    operands (the transpose flag), so nothing is transposed.
//  * Fused route, C = 96 / 192 (ffn_fused_kernel): a block holds its t rows
//    for the whole call and streams W1 / W2 in BH = 64 wide hidden chunks
//    through a 3-stage ring of 16-byte cp.async copies that every thread
//    issues a chunk ahead. For each chunk, fc1's f32 64 x 64 accumulator
//    stays in registers; bias and exact erff GELU are applied there, rounded
//    to bf16, and the registers become the A operand of fc2's wgmma
//    (register A, as FlashAttention-3 feeds P). The hidden never touches
//    shared or device memory. fc2's 64 x C f32 output tile stays in
//    registers across all chunks. fc1 of the next chunk runs on the tensor
//    cores while the CUDA cores apply this chunk's GELU.
//  * Two-pass route, C % 128 == 0 (384 and up): pass 1 writes the bf16
//    hidden gelu(t @ W1 + b1) (12.6 MB at C = 384, 6.3 MB at 768: it stays
//    in the 50 MB L2), pass 2 computes residual + ls * (H @ W2 + b2). Both
//    are warp-specialised wgmma GEMMs on 128 x 128 tiles: one thread of a
//    producer warpgroup keeps a ring full with TMA copies (tensor maps with
//    the 128-byte swizzle, completion on mbarriers), two consumer
//    warpgroups run wgmma and free each stage once its products are done.
//    Pass 1 (ffn_gelu_gemm_kernel), whose erff GELU epilogue is as long as
//    its products, runs on a persistent grid, the two consumers taking
//    alternate tiles so one's epilogue overlaps the other's MMAs (halves
//    of a block's one tile where the tiles do not outnumber the SMs). Same
//    numerics: the hidden is rounded to bf16 exactly where the fused route
//    rounds it. Pass 2 (ffn_gemm_kernel) splits its depth over the grid
//    where the grid would not fill the card (the late stages have 1024 and
//    256 rows): each split writes an f32 partial and ffn_reduce_kernel adds
//    them in split order (deterministic, no atomics) and applies the
//    epilogue.
//  * Each width has one route, fixed by C alone: the widths the two routes
//    take do not overlap. At C = 192 the fused route measured faster than
//    two passes on 64-wide tiles, which were then dropped (PERF.md).
//  * The exact erff GELU is CUDA-core work, some tens of instructions an
//    element and Ch = 4C of them a row; in the two-pass route it runs in
//    pass 1's epilogue, in the fused route under the next chunk's fc1.
//  * Ragged N: rows past N load zeros and are not written.
//  * Host set-up per call: the two-pass route encodes its two tensor maps
//    per launch (host only; the pointers change with every call); the
//    dynamic shared-memory attribute is set once per kernel instantiation;
//    the workspace of the two-pass route is the caller's (ops/cuda/ffn.py
//    keeps one per stream).
//  * f32 inputs take a plain FMA tile kernel (no TF32), kept simple: it is
//    not on the bf16 main path.
//  The fused route stays on cp.async: fed by TMA from a producer
//  warpgroup it measured slower.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// shared-memory writes of the generic proxy (cp.async) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of registers that an in-flight
// wgmma writes across the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Operand tiles in shared memory use wgmma's 128-byte swizzle: rows of 64
// bf16 (128 bytes), 16-byte chunk c of row r stored at chunk c ^ (r % 8),
// in atoms of 8 rows (1024 bytes, 1024-aligned). A wider tile is a column
// of such 64-wide blocks.
//  K-major operand (ROWS x K, K contiguous): block kb = k / 64 holds
//    element (m, k) at kb*ROWS*128 + m*128 + swizzled chunk (k % 64) / 8.
//    Descriptor: sbo = 1024 (8-row groups); a k16 step advances the start
//    by 32 bytes inside the 128-byte row, a 64-wide block by ROWS*128.
//  MN-major operand (KR x N, N contiguous): block nb = n / 64 holds
//    element (k, n) at nb*KR*128 + k*128 + swizzled chunk (n % 64) / 8.
//    Descriptor: lbo = KR*128 (between 64-wide N blocks), sbo = 1024
//    (8-row K groups); a k16 step advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row % 8)) * 16);
}

// Tile loaders: every thread issues 16-byte cp.async copies; the 8 chunks
// of one 128-byte row go to 8 consecutive threads.
//  K-major: rows row0.. of a row-major (rows, ld) matrix, columns 0..K of
//  src; rows at or past rows_valid are zero-filled.
template <int ROWS, int K, int NT>
__device__ __forceinline__ void load_kmajor(uint32_t dst, const bf16* src, int ld,
                                            int rows_valid, int tid) {
  constexpr int KB = (K + 63) / 64;
#pragma unroll 4
  for (int q = tid; q < KB * ROWS * 8; q += NT) {
    const int c = q % 8, r = (q / 8) % ROWS, kb = q / (ROWS * 8);
    const int k = kb * 64 + c * 8;
    if (K % 64 != 0 && k >= K) continue;
    const bool ok = r < rows_valid;
    const unsigned s = dst + kb * ROWS * 128 + swz(r, c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src + (size_t)(ok ? r : 0) * ld + k), "r"(ok ? 16 : 0));
  }
}
//  MN-major: rows 0..KR, columns 0..N of a row-major matrix (leading
//  dimension ld) starting at src.
template <int KR, int N, int NT>
__device__ __forceinline__ void load_mnmajor(uint32_t dst, const bf16* src, int ld, int tid) {
  constexpr int NBK = (N + 63) / 64;
#pragma unroll 4
  for (int q = tid; q < NBK * KR * 8; q += NT) {
    const int c = q % 8, k = (q / 8) % KR, nb = q / (KR * 8);
    const int col = nb * 64 + c * 8;
    if (N % 64 != 0 && col >= N) continue;
    const unsigned s = dst + nb * KR * 128 + swz(k, c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + (size_t)k * ld + col));
  }
}

// wgmma.mma_async m64nNk16, f32 += bf16 * bf16. SS: A and B from shared
// memory (A K-major, B MN-major); RS: A from registers, B MN-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// fused route: fc1 -> GELU -> fc2 in registers
// ---------------------------------------------------------------------------

constexpr int BH = 64;  // hidden chunk
constexpr int SMEM_CAP = 220 * 1024;

// 1024-aligned base of the dynamic shared memory (the swizzle atoms need
// it); kernels ask for 1 KB more than their tiles
__device__ __forceinline__ uint32_t smem_base(const void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

template <int C, int WGS>
struct FusedCfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int KB = (C + 63) / 64;  // 64-wide blocks of C
  static constexpr int T_BYTES = KB * BM * 128;
  static constexpr int W1_BYTES = C * BH * 2;
  static constexpr int W2_BYTES = KB * BH * 128;
  static constexpr int STAGE = W1_BYTES + W2_BYTES;
  static constexpr int STAGES = 3;
  static constexpr int SMEM = 1024 + T_BYTES + STAGES * STAGE;
  static constexpr int N64 = C / 64, N32 = (C % 64) / 32;  // fc2 column slices
  static_assert(C % 32 == 0 && SMEM <= SMEM_CAP, "tiles exceed shared memory");
  static_assert((4 * C / BH) % 2 == 0, "chunks run in pairs");
};

// grid: row tiles of BM = 64 * WGS; one warpgroup per 64 rows, which owns
// all C output columns.
template <int C, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
ffn_fused_kernel(const bf16* __restrict__ t, const bf16* __restrict__ res,
                 const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                 const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                 const bf16* __restrict__ ls, bf16* __restrict__ out, int n) {
  using F = FusedCfg<C, WGS>;
  constexpr int CH = 4 * C, NCHUNK = CH / BH, STAGES = F::STAGES;
  constexpr int N64 = F::N64, N32 = F::N32;
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_base(smem);
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int m0 = blockIdx.x * F::BM;

  auto w1s = [&](int s) { return base + F::T_BYTES + s * F::STAGE; };
  auto w2s = [&](int s) { return base + F::T_BYTES + s * F::STAGE + F::W1_BYTES; };
  // hidden chunk i: W1[:, i*BH : +BH] (C x 64) and W2[i*BH : +BH, :] (64 x C)
  auto load_chunk = [&](int i) {
    if (i < NCHUNK) {
      const int s = i % STAGES;
      load_mnmajor<C, BH, F::THREADS>(w1s(s), w1 + i * BH, CH, tid);
      load_mnmajor<BH, C, F::THREADS>(w2s(s), w2 + (size_t)i * BH * C, C, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  load_kmajor<F::BM, C, F::THREADS>(base, t + (size_t)m0 * C, C, min(F::BM, n - m0), tid);
  load_chunk(0);  // same group as the t tile
#pragma unroll
  for (int i = 1; i < STAGES - 1; ++i) load_chunk(i);

  float acc[N64][32];
  float acc32[N32 > 0 ? N32 : 1][16];
#pragma unroll
  for (int b = 0; b < N64; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc32[0][i] = 0.f;
  float h[2][32];           // fc1 accumulators of two consecutive chunks
  uint32_t a[BH / 16][4];   // a chunk's GELU output, fc2's A fragments

  const int quad = lane % 4;
  const uint32_t t_addr = base + wg * 64 * 128;  // this warpgroup's 64 rows
  auto fence_acc = [&]() {
#pragma unroll
    for (int b = 0; b < N64; ++b) fence_regs(acc[b]);
    if (N32) fence_regs(acc32[0]);
  };
  // fc1 of chunk i: hh (64 x BH, f32) = t_rows @ W1 chunk, issued async
  auto fc1 = [&](int i, float (&hh)[32]) {
#pragma unroll
    for (int j = 0; j < 32; ++j) hh[j] = 0.f;
    wgmma_fence();
    const uint32_t w1_addr = w1s(i % STAGES);
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks)
      wgmma_ss_n64(hh, desc_sw128(t_addr + (ks / 4) * F::BM * 128 + (ks % 4) * 32, 16),
                   desc_sw128(w1_addr + ks * 2048, C * 128), 1);
    wgmma_commit();
  };
  // one chunk: GELU of fc1(i) into fc2(i), with fc1(i + 1) running on the
  // tensor cores meanwhile
  auto step = [&](int i, float (&hh)[32], float (&hn)[32]) {
    wgmma_wait<0>();  // fc1(i) and fc2(i - 1) of this warpgroup are done
    fence_regs(hh);
    fence_acc();
    cp_async_wait<STAGES - 3>();  // chunk i + 1 has landed
    fence_async_smem();
    __syncthreads();  // ... for every thread; and every fc2(i - 1) is done
    if (i + 1 < NCHUNK) fc1(i + 1, hn);
    load_chunk(i + STAGES - 1);  // into the stage chunk i - 1 used, while fc1 runs

    // bias + exact GELU in f32, rounded to bf16, packed as fc2's A
    // fragments: the accumulator's 8-column groups 2s and 2s + 1 are the
    // register A operand of k-step s
    const bf16* bias = b1 + i * BH + 2 * quad;
#pragma unroll
    for (int j = 0; j < BH / 8; ++j) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j);
      const float c0 = __low2float(bb), c1 = __high2float(bb);
      const __nv_bfloat162 top = __floats2bfloat162_rn(gelu_erf(hh[4 * j] + c0),
                                                       gelu_erf(hh[4 * j + 1] + c1));
      const __nv_bfloat162 bot = __floats2bfloat162_rn(gelu_erf(hh[4 * j + 2] + c0),
                                                       gelu_erf(hh[4 * j + 3] + c1));
      a[j / 2][(j % 2) * 2] = *reinterpret_cast<const uint32_t*>(&top);
      a[j / 2][(j % 2) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&bot);
    }

    // fc2: acc (64 x C) += gelu(h) @ W2 chunk, in 64- (and 32-) wide slices
    wgmma_fence();
    const uint32_t w2_addr = w2s(i % STAGES);
#pragma unroll
    for (int ks = 0; ks < BH / 16; ++ks) {
#pragma unroll
      for (int b = 0; b < N64; ++b)
        wgmma_rs_n64(acc[b], a[ks], desc_sw128(w2_addr + b * BH * 128 + ks * 2048, BH * 128));
      if (N32)
        wgmma_rs_n32(acc32[0], a[ks],
                     desc_sw128(w2_addr + N64 * BH * 128 + ks * 2048, BH * 128));
    }
    wgmma_commit();
  };

  cp_async_wait<STAGES - 2>();  // chunk 0 has landed
  fence_async_smem();
  __syncthreads();
  fc1(0, h[0]);
#pragma unroll 1
  for (int i = 0; i < NCHUNK; i += 2) {  // two at a time: h alternates
    step(i, h[0], h[1]);
    step(i + 1, h[1], h[0]);
  }
  wgmma_wait<0>();
  fence_acc();

  // epilogue: out = residual + ls * (acc + b2), f32, rounded once
  const int row_top = m0 + 64 * wg + 16 * warp + lane / 4;
  auto emit = [&](int col, float v00, float v01, float v10, float v11) {
    const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(b2 + col);
    float s0 = 1.f, s1 = 1.f;
    if (ls != nullptr) {
      const __nv_bfloat162 l2 = *reinterpret_cast<const __nv_bfloat162*>(ls + col);
      s0 = __low2float(l2);
      s1 = __high2float(l2);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_top + 8 * half;
      if (row < n) {
        const size_t at = (size_t)row * C + col;
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + at);
        const float o0 = ((half ? v10 : v00) + __low2float(bb)) * s0;
        const float o1 = ((half ? v11 : v01) + __high2float(bb)) * s1;
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(__low2float(r) + o0, __high2float(r) + o1);
      }
    }
  };
#pragma unroll
  for (int b = 0; b < N64; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      emit(64 * b + 8 * j + 2 * quad, acc[b][4 * j], acc[b][4 * j + 1], acc[b][4 * j + 2],
           acc[b][4 * j + 3]);
  if (N32) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit(64 * N64 + 8 * j + 2 * quad, acc32[0][4 * j], acc32[0][4 * j + 1],
           acc32[0][4 * j + 2], acc32[0][4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// two-pass route: a warp-specialised wgmma GEMM fed by TMA, with the FFN's
// epilogues
// ---------------------------------------------------------------------------

enum Epi { EPI_OUT = 0, EPI_PARTIAL = 1 };

// a block: one producer warpgroup (one thread issues the TMA copies) and
// two consumer warpgroups; tiles of 128 x 128 outputs, 64 deep a stage
constexpr int G_BM = 128, G_BN = 128, G_BK = 64, G_THREADS = 384, G_STAGES = 5;
constexpr int G_A_BYTES = G_BM * G_BK * 2;
constexpr int G_STAGE = G_A_BYTES + G_BK * G_BN * 2;
// pass 2: tiles at base + s * G_STAGE; full[G_STAGES], empty[G_STAGES] after
constexpr int G_BARS = G_STAGES * G_STAGE;
constexpr int G_SMEM = 1024 + G_BARS + 2 * G_STAGES * 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of the given parity to complete. A wait that outlasts
// any real pipeline stall (a fault in the pipeline) traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1ll << 22)) __trap();
  }
}
// 2-D TMA load of a box at (c0 inner, c1 outer) into shared memory,
// completing on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Pass 2: C (m x n) = A (m x K, row-major) @ B (K x n, row-major) over the
// depth slice [z * kps, (z + 1) * kps) of grid z, then the epilogue:
//  EPI_OUT:     out = bf16(res + ls * (C + bias))   (ls may be null)
//  EPI_PARTIAL: partial[z] = C (f32)
// grid: (ceil(m / 128), n / 128, splits). map_a: A with 64 x 128 boxes,
// map_b: B with 64 x 64 boxes, both 128-byte swizzled, which is the layout
// the descriptors read; rows past m arrive as zeros.
template <int EPI>
__global__ void __launch_bounds__(G_THREADS, 1)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, int m, int n, int kps,
                const bf16* __restrict__ bias, const bf16* __restrict__ ls,
                const bf16* __restrict__ res, bf16* __restrict__ out,
                float* __restrict__ partial) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_base(smem);
  const uint32_t full = base + G_BARS, empty = full + G_STAGES * 8;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * G_BM, n0 = blockIdx.y * G_BN, z = blockIdx.z;
  const int ktiles = kps / G_BK;
  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % G_STAGES, use = kt / G_STAGES;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);  // consumers freed it
        const uint32_t a_dst = base + s * G_STAGE, b_dst = a_dst + G_A_BYTES;
        const int k0 = z * kps + kt * G_BK;
        mbar_expect_tx(full + 8 * s, G_STAGE);
        tma_load(a_dst, &map_a, k0, m0, full + 8 * s);
        tma_load(b_dst, &map_b, n0, k0, full + 8 * s);
        tma_load(b_dst + G_BK * 128, &map_b, n0 + 64, k0, full + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup 1 takes rows 0-63 of the tile, 2 rows 64-127
  const int cw = wg - 1;
  const int warp = (tid % 128) / 32, lane = tid % 32, quad = lane % 4;
  float acc[G_BN / 2];
#pragma unroll
  for (int i = 0; i < G_BN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % G_STAGES;
    mbar_wait(full + 8 * s, (kt / G_STAGES) & 1);
    const uint32_t a_addr = base + s * G_STAGE + cw * 64 * 128;
    const uint32_t b_addr = base + s * G_STAGE + G_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks)
      wgmma_ss_n128(acc, desc_sw128(a_addr + ks * 32, 16),
                    desc_sw128(b_addr + ks * 2048, G_BK * 128), 1);
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's products are done: free its stage
    if (kt > 0 && tid % 128 == 0) mbar_arrive(empty + 8 * ((kt - 1) % G_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int row_top = m0 + 64 * cw + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < G_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * quad;
    float c0 = 0.f, c1 = 0.f, s0 = 1.f, s1 = 1.f;
    if (EPI == EPI_OUT) {
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
      c0 = __low2float(bb);
      c1 = __high2float(bb);
      if (ls != nullptr) {
        const __nv_bfloat162 l2 = *reinterpret_cast<const __nv_bfloat162*>(ls + col);
        s0 = __low2float(l2);
        s1 = __high2float(l2);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_top + 8 * half;
      if (row >= m) continue;
      const size_t at = (size_t)row * n + col;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (EPI == EPI_OUT) {
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + at);
        *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
            __low2float(r) + (v0 + c0) * s0, __high2float(r) + (v1 + c1) * s1);
      } else {
        *reinterpret_cast<float2*>(partial + (size_t)z * m * n + at) = make_float2(v0, v1);
      }
    }
  }
}

// Pass 1: out = bf16(gelu(A @ B + bias)), the GELU epilogue costing as much
// as the products. A persistent grid of min(tiles, SMs) blocks walks the
// 128 x 128 tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the two consumer
// warpgroups take alternate tiles of the walk (each the whole tile, as two
// m64 halves), so one's epilogue runs under the other's products. Each
// consumer has a ring of its own (a shared ring would let the warpgroup
// that skipped a tile run phases ahead of its barriers); the producer fills
// them in walk order. LONE: the grid has a block for every tile (the
// 256-row stage), so each block's one tile is shared instead, a m64 half to
// each consumer, both reading one ring of twice the depth (ring 0 running
// on into ring 1's stages). Maps as ffn_gemm_kernel's.
constexpr int P_RING = 3;
constexpr int P_SMEM = 1024 + 2 * P_RING * (G_STAGE + 16);

template <bool LONE>
__global__ void __launch_bounds__(G_THREADS, 1)
ffn_gelu_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, int m, int n, int k,
                     const bf16* __restrict__ bias, bf16* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = smem_base(smem);
  // ring r, stage i: tiles at base + (r * P_RING + i) * G_STAGE; barriers
  // full at bars + 16 * (r * P_RING + i), empty 8 bytes on
  const uint32_t bars = base + 2 * P_RING * G_STAGE;
  auto stage = [&](int r, int i) { return base + (r * P_RING + i) * G_STAGE; };
  auto full = [&](int r, int i) { return bars + 16 * (r * P_RING + i); };
  auto empty = [&](int r, int i) { return bars + 16 * (r * P_RING + i) + 8; };
  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles_m = (m + G_BM - 1) / G_BM, tiles = tiles_m * (n / G_BN);
  const int ktiles = k / G_BK;
  constexpr int DEPTH = LONE ? 2 * P_RING : P_RING;  // stages of a ring in use
  if (tid == 0) {
    for (int r = 0; r < 2; ++r)
      for (int i = 0; i < P_RING; ++i) {
        mbar_init(full(r, i), 1);
        mbar_init(empty(r, i), LONE ? 2 : 1);  // an arrival per reader
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int its[2] = {0, 0};
      int walk = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++walk) {
        const int r = walk % 2;
        const int m0 = (tile % tiles_m) * G_BM, n0 = (tile / tiles_m) * G_BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          const int it = its[r]++;
          const int i = it % DEPTH, use = it / DEPTH;
          if (use > 0) mbar_wait(empty(r, i), (use - 1) & 1);
          const uint32_t a_dst = stage(r, i), b_dst = a_dst + G_A_BYTES;
          mbar_expect_tx(full(r, i), G_STAGE);
          tma_load(a_dst, &map_a, kt * G_BK, m0, full(r, i));
          tma_load(b_dst, &map_b, n0, kt * G_BK, full(r, i));
          tma_load(b_dst + G_BK * 128, &map_b, n0 + 64, kt * G_BK, full(r, i));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, ring = LONE ? 0 : cw;  // this consumer's ring
  const int warp = (tid % 128) / 32, lane = tid % 32, quad = lane % 4;
  constexpr int HALVES = LONE ? 1 : 2;  // m64 halves of a tile computed here
  int it = 0, walk = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++walk) {
    if (!LONE && walk % 2 != cw) continue;  // the other warpgroup's tile
    const int m0 = (tile % tiles_m) * G_BM, n0 = (tile / tiles_m) * G_BN;
    float acc[2][G_BN / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < G_BN / 2; ++j) acc[h][j] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int i = it % DEPTH;
      mbar_wait(full(ring, i), (it / DEPTH) & 1);
      const uint32_t a_addr = stage(ring, i) + (LONE ? cw * 64 * 128 : 0);
      const uint32_t b_addr = stage(ring, i) + G_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < G_BK / 16; ++ks) {
        const uint64_t db = desc_sw128(b_addr + ks * 2048, G_BK * 128);
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
          wgmma_ss_n128(acc[h], desc_sw128(a_addr + h * 64 * 128 + ks * 32, 16), db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && tid % 128 == 0) mbar_arrive(empty(ring, (it - 1) % DEPTH));
    }
    wgmma_wait<0>();
    if (tid % 128 == 0) mbar_arrive(empty(ring, (it - 1) % DEPTH));
    fence_regs(acc[0]);
    fence_regs(acc[1]);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const int row_top = m0 + 64 * (LONE ? cw : h) + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < G_BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * quad;
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        const float c0 = __low2float(bb), c1 = __high2float(bb);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row_top + 8 * half;
          if (row < m)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
                __floats2bfloat162_rn(gelu_erf(acc[h][4 * j + 2 * half] + c0),
                                      gelu_erf(acc[h][4 * j + 2 * half + 1] + c1));
        }
      }
    }
  }
}

// out = residual + ls * (sum over splits, in split order, + b2)
__global__ void __launch_bounds__(256)
ffn_reduce_kernel(const float* __restrict__ partial, int splits,
                  const bf16* __restrict__ res, const bf16* __restrict__ b2,
                  const bf16* __restrict__ ls, bf16* __restrict__ out, int n, int c) {
  const size_t total = (size_t)n * c;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s) o += partial[s * total + i];
    const int col = (int)(i % c);
    o += to_f(b2[col]);
    if (ls != nullptr) o *= to_f(ls[col]);
    out[i] = __float2bfloat16(to_f(res[i]) + o);
  }
}

// ---------------------------------------------------------------------------
// host side of the bf16 route
// ---------------------------------------------------------------------------

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// The route of each bf16 width (Ch = 4C): fused for C = 96 / 192, two
// passes for C % 128 == 0; none for any other C.
bool fused_width(int c) { return c == 96 || c == 192; }
bool two_pass_width(int c) { return c % 128 == 0; }

// Depth splits of pass 2: double while the doubled grid still fits in one
// wave and each split keeps a whole number of 64-deep tiles.
int pass2_splits(int n, int c) {
  const int blocks = ((n + G_BM - 1) / G_BM) * (c / G_BN);
  const int ch = 4 * c;
  int splits = 1;
  while (blocks * splits * 2 <= sm_count() && (ch / (splits * 2)) % G_BK == 0 &&
         splits < 8)
    splits *= 2;
  return splits;
}

// bytes of workspace the two-pass route needs: the bf16 hidden, then the
// f32 partials of a split pass 2
size_t two_pass_workspace(int n, int c) {
  const size_t hidden = ((size_t)n * 4 * c * 2 + 255) / 256 * 256;
  const int splits = pass2_splits(n, c);
  return hidden + (splits > 1 ? (size_t)splits * n * c * 4 : 0);
}

template <int C, int WGS>
cudaError_t launch_fused(const void* t, const void* res, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* ls, void* out, int n,
                         cudaStream_t stream) {
  using F = FusedCfg<C, WGS>;
  static cudaError_t attr = cudaFuncSetAttribute(
      ffn_fused_kernel<C, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (attr != cudaSuccess) return attr;
  ffn_fused_kernel<C, WGS><<<(n + F::BM - 1) / F::BM, F::THREADS, F::SMEM, stream>>>(
      (const bf16*)t, (const bf16*)res, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
      (const bf16*)b2, (const bf16*)ls, (bf16*)out, n);
  return cudaGetLastError();
}

// A row-major (rows, cols) bf16 matrix as a TMA tensor map of (box_cols x
// box_rows) boxes with the 128-byte swizzle. cuTensorMapEncodeTiled is a
// driver call, reached through the runtime once; encoding is host work
// only (no device call), a few per launch, since the pointers change.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (fn == nullptr || q != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int EPI>
cudaError_t launch_gemm(const void* a, const void* bm, int m, int n, int k, int splits,
                        const void* bias, const void* ls, const void* res, void* out,
                        float* partial, cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      ffn_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a, map_b;
  cudaError_t err = tensor_map(&map_a, a, m, k, G_BM);
  if (err == cudaSuccess) err = tensor_map(&map_b, bm, k, n, G_BK);
  if (err != cudaSuccess) return err;
  dim3 grid((m + G_BM - 1) / G_BM, n / G_BN, splits);
  ffn_gemm_kernel<EPI><<<grid, G_THREADS, G_SMEM, stream>>>(
      map_a, map_b, m, n, k / splits, (const bf16*)bias, (const bf16*)ls, (const bf16*)res,
      (bf16*)out, partial);
  return cudaGetLastError();
}

template <bool LONE>
cudaError_t launch_gelu_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b, int m,
                             int n, int k, int grid, const void* bias, void* out,
                             cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      ffn_gelu_gemm_kernel<LONE>, cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  if (attr != cudaSuccess) return attr;
  ffn_gelu_gemm_kernel<LONE><<<grid, G_THREADS, P_SMEM, stream>>>(
      map_a, map_b, m, n, k, (const bf16*)bias, (bf16*)out);
  return cudaGetLastError();
}

// pass 1 on min(tiles, SMs) blocks
cudaError_t launch_pass1(const void* a, const void* bm, int m, int n, int k,
                         const void* bias, void* out, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  cudaError_t err = tensor_map(&map_a, a, m, k, G_BM);
  if (err == cudaSuccess) err = tensor_map(&map_b, bm, k, n, G_BK);
  if (err != cudaSuccess) return err;
  const int tiles = ((m + G_BM - 1) / G_BM) * (n / G_BN);
  if (tiles <= sm_count())
    return launch_gelu_gemm<true>(map_a, map_b, m, n, k, tiles, bias, out, stream);
  return launch_gelu_gemm<false>(map_a, map_b, m, n, k, sm_count(), bias, out, stream);
}

cudaError_t launch_pass2(const void* hidden, const void* res, const void* w2,
                         const void* b2, const void* ls, void* out, float* partial, int n,
                         int c, cudaStream_t stream) {
  const int splits = pass2_splits(n, c);
  if (splits == 1)
    return launch_gemm<EPI_OUT>(hidden, w2, n, c, 4 * c, 1, b2, ls, res, out, nullptr,
                                stream);
  cudaError_t err = launch_gemm<EPI_PARTIAL>(hidden, w2, n, c, 4 * c, splits, nullptr,
                                             nullptr, nullptr, nullptr, partial, stream);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)n * c;
  const size_t want = (total + 255) / 256, cap = (size_t)sm_count() * 8;
  ffn_reduce_kernel<<<(int)(want < cap ? want : cap), 256, 0, stream>>>(
      partial, splits, (const bf16*)res, (const bf16*)b2, (const bf16*)ls, (bf16*)out, n, c);
  return cudaGetLastError();
}

cudaError_t two_pass(const void* t, const void* res, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* ls, void* out,
                     void* workspace, int n, int c, cudaStream_t stream) {
  if (workspace == nullptr) return cudaErrorInvalidValue;
  bf16* hidden = static_cast<bf16*>(workspace);
  float* partial = reinterpret_cast<float*>(
      static_cast<char*>(workspace) + ((size_t)n * 4 * c * 2 + 255) / 256 * 256);
  const cudaError_t err = launch_pass1(t, w1, n, 4 * c, c, b1, hidden, stream);
  if (err != cudaSuccess) return err;
  return launch_pass2(hidden, res, w2, b2, ls, out, partial, n, c, stream);
}

cudaError_t fused(const void* t, const void* res, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* ls, void* out, int n, int c,
                  cudaStream_t stream) {
  switch (c) {
    case 96: return launch_fused<96, 2>(t, res, w1, b1, w2, b2, ls, out, n, stream);
    case 192: return launch_fused<192, 2>(t, res, w1, b1, w2, b2, ls, out, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32 route: plain FMA tiles (full f32, no TF32), any C and Ch
// ---------------------------------------------------------------------------

constexpr int F_BM = 32, F_BN = 64, F_BH = 32, F_BK = 32;

__global__ void __launch_bounds__(256)
ffn_f32_kernel(const float* __restrict__ t, const float* __restrict__ res,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ ls, float* __restrict__ out,
               int n, int c, int ch) {
  __shared__ float ts[F_BM][F_BK + 1];
  __shared__ float w1s[F_BK][F_BH + 1];
  __shared__ float hs[F_BM][F_BH + 1];
  __shared__ float w2s[F_BH][F_BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * F_BM, n0 = blockIdx.y * F_BN;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int h0 = 0; h0 < ch; h0 += F_BH) {
    float hacc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < c; k0 += F_BK) {
      for (int i = tid; i < F_BM * F_BK; i += 256) {
        const int r = i / F_BK, kk = i % F_BK;
        const int gr = m0 + r, gk = k0 + kk;
        ts[r][kk] = (gr < n && gk < c) ? t[(size_t)gr * c + gk] : 0.f;
      }
      for (int i = tid; i < F_BK * F_BH; i += 256) {
        const int kk = i / F_BH, hh = i % F_BH;
        const int gk = k0 + kk, gh = h0 + hh;
        w1s[kk][hh] = (gk < c && gh < ch) ? w1[(size_t)gk * ch + gh] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < F_BK; ++kk) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            hacc[i][j] = fmaf(ts[ty * 2 + i][kk], w1s[kk][tx * 2 + j], hacc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gh = h0 + tx * 2 + j;
        hs[ty * 2 + i][tx * 2 + j] = gh < ch ? gelu_erf(hacc[i][j] + b1[gh]) : 0.f;
      }
    for (int i = tid; i < F_BH * F_BN; i += 256) {
      const int hh = i / F_BN, cc = i % F_BN;
      const int gh = h0 + hh, gc = n0 + cc;
      w2s[hh][cc] = (gh < ch && gc < c) ? w2[(size_t)gh * c + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int hh = 0; hh < F_BH; ++hh) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(hs[ty * 2 + i][hh], w2s[hh][tx * 4 + j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 2 + i, gc = n0 + tx * 4 + j;
      if (gr < n && gc < c) {
        float o = acc[i][j] + b2[gc];
        if (ls != nullptr) o *= ls[gc];
        const size_t at = (size_t)gr * c + gc;
        out[at] = res[at] + o;
      }
    }
}

}  // namespace

extern "C" {

const char* fvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of workspace fvlm_fused_ffn needs for this shape (0: none; -1: the
// bf16 kernel does not take this shape).
long long fvlm_ffn_workspace(int n, int c, int ch, int dtype) {
  if (dtype == 0) return 0;
  if (ch != 4 * c || !(fused_width(c) || two_pass_width(c))) return -1;
  return two_pass_width(c) ? (long long)two_pass_workspace(n, c) : 0;
}

// t, res, out: (n, c); w1: (c, ch); w2: (ch, c); b1: (ch,); b2, ls: (c,),
// all row-major in one dtype (0 float32, 1 bfloat16). ls may be null.
// workspace: fvlm_ffn_workspace(...) bytes, or null when that is 0.
// Launches on `stream` and returns the launches' CUDA error code.
int fvlm_fused_ffn(const void* t, const void* res, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* ls, void* out,
                   void* workspace, int n, int c, int ch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    dim3 grid((n + F_BM - 1) / F_BM, (c + F_BN - 1) / F_BN);
    ffn_f32_kernel<<<grid, 256, 0, s>>>(
        (const float*)t, (const float*)res, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (const float*)ls, (float*)out, n, c, ch);
    err = cudaGetLastError();
  } else if (dtype == 1 && ch == 4 * c) {
    if (fused_width(c))
      err = fused(t, res, w1, b1, w2, b2, ls, out, n, c, s);
    else if (two_pass_width(c))
      err = two_pass(t, res, w1, b1, w2, b2, ls, out, workspace, n, c, s);
    else
      err = cudaErrorInvalidValue;
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
