// Kernel K1: the fused ConvFFN pointwise half, written by hand for Hopper
// (sm_90a).
//
// Replaces: fastvlm_tpu/ops/pallas/ffn.py::fused_ffn (Pallas, TPU).
// Computes, over N token rows of width C and hidden width Ch = 4C:
//     out = residual + ls * (gelu_erf(t @ W1 + b1) @ W2 + b2)
// with f32 accumulation, exact erf GELU, and the GELU output rounded to the
// input dtype before fc2, as the Pallas kernel does. ls may be null (the
// layer scale folded into W2/b2), which skips the multiply.
//
// What bounds it on this card: tensor-core throughput. At the FastViTHD
// shapes (C = 96..1536) the two products do 4*N*C*Ch FLOPs for 3*N*C
// elements of t/residual/out, i.e. 256 (C = 96) to 4096 (C = 1536) FLOPs per
// byte in bf16, at or above the card's ridge of ~295. Unfused, the (N, 4C)
// hidden would be written and read back once each: 8/3 times the traffic of
// t, residual and out together.
//
// Design:
//  * bf16 inputs: one block owns BM = 64 rows and BN = 32*NF (NF = 12, 6 or 3)
//    output columns. It loops over the hidden width in BH = 64 chunks:
//    fc1 on WMMA (mma.sync) tensor cores, f32 accumulate, streamed over C
//    in BK = 32 steps through a two-stage cp.async ring; bias + GELU in f32,
//    rounded to the input dtype into shared memory; then fc2 accumulates
//    that chunk into f32 WMMA fragments held in registers. The hidden never
//    leaves the SM.
//  * The f32 output tile is what limits a block: 64 x 1536 f32 is 384 KB,
//    beyond both shared memory and registers. So a block takes at most
//    BN = 384 columns (96 f32 registers a thread over 8 warps), and at
//    C = 768 / 1536 the 2 / 4 column tiles each recompute the fc1 chunk.
//  * Too few blocks: the late stages have few rows (1024 and 256 at
//    1024 px), i.e. 16 to 64 row-x-column tiles for 132 SMs. There the
//    hidden width is split over the grid's z axis until the grid covers the
//    SMs; each split writes its f32 partial fc2 sum to a workspace, and a
//    second pass adds the splits in a fixed order (deterministic) and applies
//    the epilogue.
//  * Ragged N: rows past N load zeros and are not written; no N % BM rule.
//  * f32 inputs take a plain FMA tile kernel (no TF32), kept simple: it is
//    not on the bf16 main path.
//  Not yet: wgmma, TMA, warp specialisation, a persistent grid (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// 16-byte global -> shared copy; with valid == false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// bf16 route: WMMA back-to-back products
// ---------------------------------------------------------------------------

constexpr int BM = 64;        // token rows per block
constexpr int BK = 32;        // fc1 depth step over C
constexpr int BH = 64;        // hidden chunk
constexpr int WARPS = 8;      // 4 row groups of 16 x 2 column groups
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;        // 16-bit row padding: keeps 32-byte fragment
                              // alignment and staggers banks
constexpr int TS_LD = BK + PAD;
constexpr int W1_LD = BH + PAD;
constexpr int HF_LD = BH + 4;  // f32
constexpr int HS_LD = BH + PAD;
constexpr int SC_LD = 16 + 4;  // f32, per-warp epilogue scratch

template <typename T, int NF>
struct Smem {
  static constexpr int BN = 32 * NF;
  static constexpr int W2_LD = BN + PAD;
  static constexpr size_t ts_stage = BM * TS_LD * sizeof(T);
  static constexpr size_t w1_stage = BK * W1_LD * sizeof(T);
  static constexpr size_t ts = 0;                       // 2 stages
  static constexpr size_t w1 = ts + 2 * ts_stage;       // 2 stages
  static constexpr size_t hf = w1 + 2 * w1_stage;
  static constexpr size_t hs = hf + BM * HF_LD * sizeof(float);
  static constexpr size_t w2 = hs + BM * HS_LD * sizeof(T);
  static constexpr size_t sc = w2 + BH * W2_LD * sizeof(T);
  static constexpr size_t bytes = sc + WARPS * 16 * SC_LD * sizeof(float);
};

// grid: (row tiles, column tiles, hidden splits). With partial == nullptr
// (one split) the block writes out; otherwise it writes its f32 partial
// fc2 sum to partial[split][n][c] and ffn_reduce_kernel finishes.
template <typename T, int NF>
__global__ void __launch_bounds__(THREADS)
ffn_wmma_kernel(const T* __restrict__ t, const T* __restrict__ res,
                const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ w2, const T* __restrict__ b2,
                const T* __restrict__ ls, T* __restrict__ out,
                float* __restrict__ partial, int n, int c, int ch,
                int h_per_split) {
  using S = Smem<T, NF>;
  constexpr int BN = S::BN;
  constexpr int W2_LD = S::W2_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ts = reinterpret_cast<T*>(smem + S::ts);
  T* w1s = reinterpret_cast<T*>(smem + S::w1);
  float* hf = reinterpret_cast<float*>(smem + S::hf);
  T* hs = reinterpret_cast<T*>(smem + S::hs);
  T* w2s = reinterpret_cast<T*>(smem + S::w2);
  float* sc = reinterpret_cast<float*>(smem + S::sc);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int h_begin = blockIdx.z * h_per_split;
  const int h_end = h_begin + h_per_split;
  const int nk = c / BK;

  // this thread's 16-byte pieces of a t tile (64 x 32) and a W1 tile (32 x 64)
  const int t_row = tid / 4, t_vc = tid % 4;
  const bool t_ok = m0 + t_row < n;
  const T* t_src = t + (size_t)(t_ok ? m0 + t_row : 0) * c + t_vc * 8;
  const int w_row = tid / 8, w_vc = tid % 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int h0 = h_begin; h0 < h_end; h0 += BH) {
    __syncthreads();  // the previous chunk's fc2 is done with w2s / hs
    // W2 chunk (BH x BN) as its own group, then the first fc1 stage
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / (BN / 8), vc = idx % (BN / 8);
      cp_async16(w2s + row * W2_LD + vc * 8,
                 w2 + (size_t)(h0 + row) * c + n0 + vc * 8, true);
    }
    cp_async_commit();
    auto load_stage = [&](int step) {
      const int k0 = step * BK, buf = step & 1;
      cp_async16(ts + buf * (BM * TS_LD) + t_row * TS_LD + t_vc * 8, t_src + k0, t_ok);
      cp_async16(w1s + buf * (BK * W1_LD) + w_row * W1_LD + w_vc * 8,
                 w1 + (size_t)(k0 + w_row) * ch + h0 + w_vc * 8, true);
      cp_async_commit();
    };
    load_stage(0);

    // ---- fc1: (BM x C) @ (C x BH), two-stage ring over C ----
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2];
    wmma::fill_fragment(hacc[0], 0.0f);
    wmma::fill_fragment(hacc[1], 0.0f);
    for (int s = 0; s < nk; ++s) {
      if (s + 1 < nk) {
        load_stage(s + 1);
        cp_async_wait<1>();  // all but the stage just requested have landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* tb = ts + (s & 1) * (BM * TS_LD);
      const T* wb = w1s + (s & 1) * (BK * W1_LD);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, tb + (wr * 16) * TS_LD + kk, TS_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
          wmma::load_matrix_sync(b, wb + kk * W1_LD + wc * 32 + j * 16, W1_LD);
          wmma::mma_sync(hacc[j], a, b, hacc[j]);
        }
      }
      __syncthreads();  // the stage read here is refilled two steps on
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(hf + (wr * 16) * HF_LD + wc * 32 + j * 16, hacc[j],
                              HF_LD, wmma::mem_row_major);
    __syncthreads();
    // ---- bias + exact GELU in f32, rounded to the input dtype ----
    for (int i = tid; i < BM * BH; i += THREADS) {
      const int r = i / BH, col = i % BH;
      const float v = hf[r * HF_LD + col] + to_f(b1[h0 + col]);
      hs[r * HS_LD + col] = from_f<T>(gelu_erf(v));
    }
    __syncthreads();
    // ---- fc2: acc += (BM x BH) @ (BH x BN); W2 landed with stage 0 ----
#pragma unroll
    for (int kk = 0; kk < BH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, hs + (wr * 16) * HS_LD + kk, HS_LD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(b, w2s + kk * W2_LD + wc * (16 * NF) + f * 16, W2_LD);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }

  // ---- epilogue, one fragment at a time through per-warp scratch:
  //      out = residual + ls * (acc + b2), or the f32 partial sum
  float* wsc = sc + warp * 16 * SC_LD;
  const int row0 = m0 + wr * 16;
  const int col0 = n0 + wc * 16 * NF;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(wsc, acc[f], SC_LD, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, cc = e % 16;
      const int grow = row0 + r, gcol = col0 + f * 16 + cc;
      if (grow < n) {
        const size_t at = (size_t)grow * c + gcol;
        if (partial != nullptr) {
          partial[(size_t)blockIdx.z * n * c + at] = wsc[r * SC_LD + cc];
        } else {
          float o = wsc[r * SC_LD + cc] + to_f(b2[gcol]);
          if (ls != nullptr) o *= to_f(ls[gcol]);
          out[at] = from_f<T>(to_f(res[at]) + o);
        }
      }
    }
    __syncwarp();
  }
}

// out = residual + ls * (sum over splits, in split order, + b2)
template <typename T>
__global__ void __launch_bounds__(256)
ffn_reduce_kernel(const float* __restrict__ partial, int splits,
                  const T* __restrict__ res, const T* __restrict__ b2,
                  const T* __restrict__ ls, T* __restrict__ out, int n, int c) {
  const size_t total = (size_t)n * c;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s) o += partial[s * total + i];
    const int col = (int)(i % c);
    o += to_f(b2[col]);
    if (ls != nullptr) o *= to_f(ls[col]);
    out[i] = from_f<T>(to_f(res[i]) + o);
  }
}

// Output columns per block: BN = 32 * NF, the widest of 384 / 192 / 96 that
// divides C (FastViTHD's widths are 96 * 2^i).
int pick_nf(int c) {
  const int options[] = {12, 6, 3};
  for (int nf : options)
    if (c % (32 * nf) == 0) return nf;
  return 0;
}

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

// Hidden splits: double until the grid covers the SMs, while each split
// keeps a whole number of BH chunks.
int pick_splits(int n, int c, int ch) {
  const int tiles = ((n + BM - 1) / BM) * (c / (32 * pick_nf(c)));
  int splits = 1;
  while (tiles * splits < sm_count() && ch % (splits * 2 * BH) == 0) splits *= 2;
  return splits;
}

bool wmma_supported(int c, int ch) { return pick_nf(c) != 0 && ch % BH == 0; }

template <typename T, int NF>
cudaError_t launch_wmma(const void* t, const void* res, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* ls, void* out,
                        float* partial, int splits, int n, int c, int ch,
                        cudaStream_t stream) {
  const size_t bytes = Smem<T, NF>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_wmma_kernel<T, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BM - 1) / BM, c / (32 * NF), splits);
  ffn_wmma_kernel<T, NF><<<grid, THREADS, bytes, stream>>>(
      (const T*)t, (const T*)res, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, (const T*)ls, (T*)out, splits > 1 ? partial : nullptr, n, c, ch,
      ch / splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)n * c;
  const size_t want = (total + 255) / 256, cap = (size_t)sm_count() * 8;
  const int blocks = (int)(want < cap ? want : cap);
  ffn_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      partial, splits, (const T*)res, (const T*)b2, (const T*)ls, (T*)out, n, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wmma(const void* t, const void* res, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* ls, void* out,
                          float* workspace, int n, int c, int ch, cudaStream_t stream) {
  if (!wmma_supported(c, ch)) return cudaErrorInvalidValue;
  const int splits = pick_splits(n, c, ch);
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
#define FVLM_LAUNCH(NF_)                                                         \
  return launch_wmma<T, NF_>(t, res, w1, b1, w2, b2, ls, out, workspace, splits, \
                             n, c, ch, stream)
  switch (pick_nf(c)) {
    case 12: FVLM_LAUNCH(12);
    case 6: FVLM_LAUNCH(6);
    case 3: FVLM_LAUNCH(3);
    default: return cudaErrorInvalidValue;
  }
#undef FVLM_LAUNCH
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

// f32 elements of workspace fvlm_fused_ffn needs for this shape (0: none).
long long fvlm_ffn_workspace(int n, int c, int ch, int dtype) {
  if (dtype == 0 || !wmma_supported(c, ch)) return 0;
  const int splits = pick_splits(n, c, ch);
  return splits > 1 ? (long long)splits * n * c : 0;
}

// t, res, out: (n, c); w1: (c, ch); w2: (ch, c); b1: (ch,); b2, ls: (c,),
// all row-major in one dtype (0 float32, 1 bfloat16). ls may be
// null. workspace: fvlm_ffn_workspace(...) f32 elements, or null when that
// is 0. Launches on `stream` and returns the launches' CUDA error code.
int fvlm_fused_ffn(const void* t, const void* res, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* ls, void* out,
                   void* workspace, int n, int c, int ch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err;
  if (dtype == 0) {
    dim3 grid((n + F_BM - 1) / F_BM, (c + F_BN - 1) / F_BN);
    ffn_f32_kernel<<<grid, 256, 0, s>>>(
        (const float*)t, (const float*)res, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (const float*)ls, (float*)out, n, c, ch);
    err = cudaGetLastError();
  } else if (dtype == 1) {
    err = dispatch_wmma<__nv_bfloat16>(t, res, w1, b1, w2, b2, ls, out, ws, n, c, ch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
