// The body of kernels K2 (csrc/decode_attention.cu, a dense KV cache) and
// K3 (csrc/paged_decode_attention.cu, a page pool read through block
// tables): decode attention of one query token per row as one-launch flash
// decoding, written by hand for Hopper (sm_90a). The two kernels differ
// only in where a key's K and V rows lie, which decode_body takes as a
// template parameter (Rows).
//
// Semantics: q is pre-scaled by D^-0.5 in q's dtype; keys at or past the
// row's length are masked with -1e30; softmax and the P.V sum in f32; the
// denominator floored at 1e-30; output in q's dtype. GQA: query head h
// reads KV head h / (Hq / Hkv).
//
// Design:
//  * One launch. A split of the keys is one cluster of CL = 8 blocks (one
//    per SM), block r taking the r-th eighth; a block is 4 warps, each
//    taking 16 keys of every 64-key block tile. Each warp streams its K and
//    V rows through a 2-stage cp.async ring of its own (no block barrier in
//    the loop) and keeps an online softmax (running max, sum, f32 P.V) for
//    all G = Hq / Hkv query heads of its KV head, padded to 16 rows.
//  * A warp locates its 16 keys once a tile (Rows::tile: a paged caller
//    reads its block table there), for the tile after next while this one
//    computes, so no address lookup stands in front of the copies.
//  * The first two tiles are requested before the length arrives (rows up
//    to the capacity; V rows found past the length are zeroed), and q is
//    read after them, so every first trip to memory overlaps.
//  * bf16: Q.K^T and P.V run on mma.sync m16n8k16 (bf16 in, f32 sums). Q.K^T
//    multiplies bf16 values exactly, as the f32 reference does. P is f32:
//    it enters P.V as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi),
//    so P carries 16 significant bits into the f32 sum (relative error
//    <= 2^-16 a weight) against 8 for a single bf16 P. V's fragments come
//    from shared memory by ldmatrix.trans. f32: the same state and tiles,
//    with plain FMAs.
//  * Merges, all in a fixed order (deterministic): a block's warps through
//    shared memory; the cluster's 8 blocks through distributed shared
//    memory after a cluster barrier, each block producing every 8th pair of
//    output columns. A row whose keys fit one split (up to 512 keys at
//    batch 1 and the 0.5B heads) is then done. Longer rows use several
//    clusters: each writes its split's partial (max, sum, P.V) to a
//    workspace, and the last block to arrive, known from an arrival counter
//    in device memory (atomicAdd after __threadfence), merges the splits in
//    split order, writes the output and resets the counter, so the
//    workspace is reused without a memset. Splits wholly past the length
//    read no K or V past the prefetch and carry zero weight.
//  * The split size is chosen on the host (pick_split): whole 64-key tiles
//    a block, the fewest that keep the grid near one block per SM (split
//    count <= 256).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int KT = 16;              // keys a warp takes from a tile
constexpr int GMAX = 16;            // query heads per KV head (mma rows)
constexpr int MAX_SPLITS = 256;
constexpr int CL = 8;               // blocks of a cluster: one split, merged on chip
constexpr int WARPS = 4;            // warps of a block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Shared memory of one block of 4 warps. Rows of D elements are padded by
// 16 bytes, so consecutive rows start 4 banks apart (conflict-free fragment
// loads).
template <typename T, int D>
struct Smem {
  static constexpr int LD = D + 16 / (int)sizeof(T);          // elements a row
  static constexpr int ROW = LD * (int)sizeof(T);             // bytes a row
  static constexpr int KV_STAGE = 2 * KT * ROW;               // K rows, then V rows
  static constexpr int KV_WARP = 2 * KV_STAGE;                // a warp's 2 stages
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TILE = WARPS * KT;                     // keys of a block tile
  static constexpr int Q = 0;                                 // [GMAX][LD]
  static constexpr int KV = Q + GMAX * ROW;                   // per warp
  static constexpr int LOOP_BYTES = KV + WARPS * KV_WARP;
  // after the loop the same memory holds the warps' states ...
  // (rows of D + 8 floats: a half-warp's 8-byte stores of 4 heads x 4
  // column pairs land in 32 distinct banks)
  static constexpr int LDA = D + 8;
  static constexpr int ACC = 0;                               // [WARPS][GMAX][LDA] f32
  static constexpr int ML = ACC + WARPS * GMAX * LDA * 4;     // [WARPS][GMAX][2] f32
  static constexpr int WGT = ML + WARPS * GMAX * 2 * 4;      // [WARPS][GMAX] weights,
  static constexpr int BML = WGT + WARPS * GMAX * 4;          // then [GMAX][2] max, sum
  static constexpr int BACC = BML + GMAX * 2 * 4;             // the block's P.V [GMAX][D]
  static constexpr int MERGE_BYTES = BACC + GMAX * D * 4;
  // ... and, in the merging block, the splits' weights and sums
  static constexpr int W_BYTES = 2 * GMAX * MAX_SPLITS * 4 + GMAX * 4;
  static constexpr int BYTES = LOOP_BYTES > MERGE_BYTES
                                   ? (LOOP_BYTES > W_BYTES ? LOOP_BYTES : W_BYTES)
                                   : (MERGE_BYTES > W_BYTES ? MERGE_BYTES : W_BYTES);
};

// One warp's running state over its keys: rows g and g + 8 of the 16 padded
// query heads (g = lane / 4), in the mma accumulator layout: s[nt][e] is
// the score of row g + 8 * (e / 2) and key 8 nt + 2 (lane % 4) + e % 2;
// acc[dn][e] the P.V sum of that row and column 8 dn + 2 (lane % 4) + e % 2.
template <int D>
struct WarpState {
  float m[2], l[2];  // running max (quad-uniform) and this thread's part of the sum
  float acc[D / 8][4];
};

// Scores of the warp's 16 keys, bf16: Q.K^T on mma.sync
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* ks, int lane) {
  constexpr int LD = Smem<__nv_bfloat16, D>::LD;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const __nv_bfloat16* krow = ks + (8 * nt + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(krow + 16 * kk),
               *reinterpret_cast<const uint32_t*>(krow + 16 * kk + 8));
  }
}
// ... f32: plain FMAs from shared memory
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4], const float* qs, const float* ks,
                                       int lane) {
  constexpr int LD = Smem<float, D>::LD;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* qrow = qs + (g + 8 * (e / 2)) * LD;
      const float* krow = ks + (8 * nt + 2 * t + e % 2) * LD;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], krow[d], acc);
      s[nt][e] = acc;
    }
}

// acc += P (16 x 16 keys) . V (16 keys x D), bf16 V: P as hi + lo bf16 terms
template <int D>
__device__ __forceinline__ void pv(WarpState<D>& st, const float (&p)[2][4],
                                   const __nv_bfloat16* vs, int lane) {
  constexpr int LD = Smem<__nv_bfloat16, D>::LD;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // A fragment r: key half r / 2, row half r % 2
    const float a = p[r / 2][2 * (r % 2)], b = p[r / 2][2 * (r % 2) + 1];
    hi[r] = pack_bf16(a, b);
    const float2 h = unpack_bf16(hi[r]);
    lo[r] = pack_bf16(a - h.x, b - h.y);
  }
  const int row = (lane % 8) + 8 * ((lane / 8) % 2), col = 8 * (lane / 16);
  const uint32_t base = smem_u32(vs + row * LD + col);
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, base + i * 16 * (int)sizeof(__nv_bfloat16));
    mma_bf16(st.acc[2 * i], hi, b[0], b[1]);
    mma_bf16(st.acc[2 * i], lo, b[0], b[1]);
    mma_bf16(st.acc[2 * i + 1], hi, b[2], b[3]);
    mma_bf16(st.acc[2 * i + 1], lo, b[2], b[3]);
  }
}
// ... f32: each key's weights from the quad that holds them
template <int D>
__device__ __forceinline__ void pv(WarpState<D>& st, const float (&p)[2][4], const float* vs,
                                   int lane) {
  constexpr int LD = Smem<float, D>::LD;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int src = 4 * g + (kk % 8) / 2;
    const float p0 = __shfl_sync(0xffffffffu, p[kk / 8][kk % 2], src);
    const float p1 = __shfl_sync(0xffffffffu, p[kk / 8][2 + kk % 2], src);
    const float* vrow = vs + kk * LD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float v0 = vrow[8 * dn], v1 = vrow[8 * dn + 1];
      st.acc[dn][0] = fmaf(p0, v0, st.acc[dn][0]);
      st.acc[dn][1] = fmaf(p0, v1, st.acc[dn][1]);
      st.acc[dn][2] = fmaf(p1, v0, st.acc[dn][2]);
      st.acc[dn][3] = fmaf(p1, v1, st.acc[dn][3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Online-softmax update of the warp's state with one tile's scores; keys at
// or past kend (global index key0 + local key) are masked.
template <int D>
__device__ __forceinline__ void softmax_update(WarpState<D>& st, float (&s)[2][4], int key0,
                                               int kend, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * nt + 2 * t + e % 2 >= kend) s[nt][e] = NEG_INF;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mx = quad_max(fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                    fmaxf(s[1][2 * h], s[1][2 * h + 1])));
    const float m_new = fmaxf(st.m[h], mx);
    const float corr = expf(st.m[h] - m_new);
    st.m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        s[nt][e] = expf(s[nt][e] - m_new);
        sum += s[nt][e];
      }
    st.l[h] = st.l[h] * corr + sum;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      st.acc[dn][2 * h] *= corr;
      st.acc[dn][2 * h + 1] *= corr;
    }
  }
}

// The body of one block of the grid (n_split * CL, Hkv, B), clusters of CL
// blocks along x: cluster sp takes key positions [sp * split, (sp + 1) *
// split) of row b, KV head kvh, its block of rank r the r-th CL-th of them.
// Where a key's K and V rows lie is the caller's (K2: a dense cache; K3: a
// page pool through a block table), as a value `rows` of a type with
//   Tile                      what locating a warp's KT keys gives;
//   Tile tile(key0, kvalid)   locates keys key0 .. key0 + KT - 1 (key0 a
//                             multiple of KT, key0 < kvalid <= s_cap; keys
//                             at or past kvalid need not be located);
//   size_t off(tile, r)       the element offset in k and v of key key0 + r
//                             (r < KT, key0 + r < kvalid).
// tile() runs once per warp and tile, a tile ahead of the copies that use
// it. s_cap: the positions that exist (rows past it are never read);
// length: this row's valid key count. q: (B, Hq, D). part_acc: (B, Hkv,
// n_split, G, D) f32; part_ml: (B, Hkv, n_split, G, 2) f32; counters:
// (B * Hkv,) int32, zero between calls.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const Rows rows, const int* length, int s_cap, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ counters, T* __restrict__ out, int hq,
    int hkv, int split, float scale) {
  using S = Smem<T, D>;
  constexpr int LD = S::LD, CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int THREADS = S::THREADS, TILE = S::TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int sp = blockIdx.x / CL, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x / CL, g_count = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = split / CL;               // this block's keys:
  const int s0 = sp * split + rank * sub;   // [s0, s0 + sub)
  const int len = min(*length, s_cap);

  // this warp's K / V ring and its share of each tile. The first two tiles
  // are located and requested before the length arrives (rows up to s_cap;
  // rows found past the length are zeroed below); later tiles read valid
  // rows only.
  using Tile = typename Rows::Tile;
  unsigned char* ring = smem + S::KV + warp * S::KV_WARP;
  auto locate = [&](int tile, int kvalid) {
    const int key0 = s0 + tile * TILE + warp * KT;
    return key0 < kvalid ? rows.tile(key0, kvalid) : Tile{};
  };
  auto load = [&](int tile, int kvalid, const Tile& at) {
    const int key0 = s0 + tile * TILE + warp * KT;
    if (key0 < kvalid) {
      const uint32_t kd = smem_u32(ring + (tile % 2) * S::KV_STAGE);
      for (int c = lane; c < KT * CPR; c += 32) {
        const int r = c / CPR, cc = c % CPR;
        const bool ok = key0 + r < kvalid;  // past it: zeros, nothing read
        const size_t off = rows.off(at, ok ? r : 0) + cc * (16 / sizeof(T));
        cp_async16(kd + r * S::ROW + cc * 16, k + off, ok);
        cp_async16(kd + (KT + r) * S::ROW + cc * 16, v + off, ok);
      }
    }
    cp_async_commit();
  };
  const int pre = min(s_cap, s0 + sub);
  const Tile at0 = locate(0, pre), at1 = locate(1, pre);
  load(0, pre, at0);
  load(1, pre, at1);

  // q * D^-0.5, rounded to q's dtype as the TPU kernel's pre-scale is; rows
  // past G are zero. bf16: straight into this lane's mma A fragments; f32:
  // into shared memory. Read after the K / V requests, so that both trips
  // to memory overlap.
  const float scale_t = to_f(from_f<T>(scale));
  const T* qh = q + ((size_t)b * hq + (size_t)kvh * g_count) * D;
  T* qs = reinterpret_cast<T*>(smem + S::Q);
  uint32_t qa[D / 16][4];
  if constexpr (sizeof(T) == 2) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r % 2), col = 16 * kk + 8 * (r / 2) + 2 * t;
        // every load issued at once: rows past G read row 0, then count 0
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            qh + (row < g_count ? row : 0) * D + col));
        const float keep = row < g_count ? scale_t : 0.f;
        qa[kk][r] = pack_bf16(x.x * keep, x.y * keep);
      }
  } else {
    for (int e = tid; e < GMAX * D; e += THREADS) {
      const int g = e / D, d = e % D;
      qs[g * LD + d] = from_f<T>(g < g_count ? to_f(qh[g * D + d]) * scale_t : 0.f);
    }
  }

  const int kend = min(len, s0 + sub);
  const int ntiles = kend > s0 ? (kend - s0 + TILE - 1) / TILE : 0;
  if constexpr (sizeof(T) != 2) __syncthreads();  // the scaled queries

  WarpState<D> st;
  st.m[0] = st.m[1] = NEG_INF;
  st.l[0] = st.l[1] = 0.f;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[dn][e] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const Tile next = locate(tile + 2, kend);  // in flight while this tile computes
    cp_async_wait<1>();  // this tile's rows (the next tile's may still fly)
    __syncwarp();
    const int key0 = s0 + tile * TILE + warp * KT;
    if (tile < 2 && key0 < kend && key0 + KT > kend) {
      // V rows of a prefetched tile past the length: zero, so that their
      // zero weights never meet a non-finite value
      unsigned char* vrows = ring + (tile % 2) * S::KV_STAGE + KT * S::ROW;
      for (int c = lane; c < KT * CPR; c += 32)
        if (key0 + c / CPR >= kend)
          *reinterpret_cast<uint4*>(vrows + (c / CPR) * S::ROW + (c % CPR) * 16) =
              make_uint4(0, 0, 0, 0);
      __syncwarp();
    }
    if (key0 < kend) {  // warp-uniform: some of the warp's keys are valid
      const T* ks = reinterpret_cast<const T*>(ring + (tile % 2) * S::KV_STAGE);
      const T* vs = ks + KT * LD;
      float s[2][4];
      if constexpr (sizeof(T) == 2)
        scores<D>(s, qa, ks, lane);
      else
        scores<D>(s, reinterpret_cast<const float*>(qs), ks, lane);
      softmax_update<D>(st, s, key0, kend, lane);
      pv<D>(st, s, vs, lane);
    }
    __syncwarp();  // the stage is read; refill it two tiles on
    load(tile + 2, kend, next);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes merge space

  // the warps' states -> shared memory
  float* wacc = reinterpret_cast<float*>(smem + S::ACC);
  float* wml = reinterpret_cast<float*>(smem + S::ML);
  {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      const float l = quad_sum(st.l[h]);
      if (t == 0) {
        wml[(warp * GMAX + row) * 2] = st.m[h];
        wml[(warp * GMAX + row) * 2 + 1] = l;
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(wacc + (warp * GMAX + row) * S::LDA + 8 * dn + 2 * t) =
            make_float2(st.acc[dn][2 * h], st.acc[dn][2 * h + 1]);
    }
  }
  __syncthreads();

  // the block's result: the warps merged in warp order. The WARPS threads
  // of head g (adjacent lanes) find its maximum and denominator by a fixed
  // shuffle tree and each keeps its warp's weight exp(m_w - m); then each
  // pair of output columns sums the warps' P.V with those weights.
  float* wgt = reinterpret_cast<float*>(smem + S::WGT);  // [WARPS][GMAX]
  float* hml = reinterpret_cast<float*>(smem + S::BML);  // [GMAX][2]: max, sum
  float* bacc = reinterpret_cast<float*>(smem + S::BACC);
  if (tid < WARPS * GMAX) {
    const int g = tid / WARPS, w = tid % WARPS;
    const float mw = wml[(w * GMAX + g) * 2];
    float m = mw;
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float wt = expf(mw - m);
    float l = wml[(w * GMAX + g) * 2 + 1] * wt;
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    wgt[w * GMAX + g] = wt;
    if (w == 0) {
      hml[2 * g] = m;
      hml[2 * g + 1] = l;
    }
  }
  __syncthreads();
  for (int e = 2 * tid; e < g_count * D; e += 2 * THREADS) {
    const int g = e / D, d = e % D;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = wgt[w * GMAX + g];
      const float2 a = *reinterpret_cast<const float2*>(wacc + (w * GMAX + g) * S::LDA + d);
      acc.x = fmaf(a.x, wt, acc.x);
      acc.y = fmaf(a.y, wt, acc.y);
    }
    *reinterpret_cast<float2*>(bacc + e) = acc;
  }

  // the cluster's CL blocks merged in rank order through distributed shared
  // memory, each block taking every CL-th pair of output columns: the
  // split's result, which is the output when the row has one split
  cluster.sync();
  const size_t group = (size_t)b * hkv + kvh;
  const size_t pbase = (group * n_split + sp) * g_count;
  T* ob = out + ((size_t)b * hq + (size_t)kvh * g_count) * D;
  for (int e = 2 * (rank + CL * tid); e < g_count * D; e += 2 * CL * THREADS) {
    const int g = e / D, d = e % D;
    float mr[CL], m = NEG_INF;
#pragma unroll
    for (int r = 0; r < CL; ++r) {
      mr[r] = cluster.map_shared_rank(hml, r)[2 * g];
      m = fmaxf(m, mr[r]);
    }
    float2 acc = make_float2(0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < CL; ++r) {
      const float wt = expf(mr[r] - m);
      const float2 a = *reinterpret_cast<const float2*>(cluster.map_shared_rank(bacc, r) + e);
      acc.x = fmaf(a.x, wt, acc.x);
      acc.y = fmaf(a.y, wt, acc.y);
      l = fmaf(cluster.map_shared_rank(hml, r)[2 * g + 1], wt, l);
    }
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      ob[e] = from_f<T>(acc.x * inv);
      ob[e + 1] = from_f<T>(acc.y * inv);
    } else {
      *reinterpret_cast<float2*>(part_acc + (pbase + g) * D + d) = acc;
      if (d == 0) {
        part_ml[(pbase + g) * 2] = m;
        part_ml[(pbase + g) * 2 + 1] = l;
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
  if (n_split == 1) return;

  // arrival: the last block of this (row, KV head) merges every split
  __shared__ int last;
  __syncthreads();  // the block's writes, then thread 0's fence releases them all
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counters + group, 1) == n_split * CL - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // The merge. Its loads go out together: the splits' partial P.V (each
  // thread owns EPT elements and holds SPC splits of them in registers) and
  // every (max, sum) pair, so the block waits on device memory about once.
  constexpr int EPT = (GMAX * D + THREADS - 1) / THREADS;
  constexpr int SPC = EPT >= 64 ? 1 : 64 / EPT;  // splits a chunk
  const float* pa = part_acc + group * n_split * g_count * D;
  auto load_chunk = [&](float (&x)[SPC][EPT], int s0) {
#pragma unroll
    for (int i = 0; i < SPC; ++i)
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        const int e = tid + j * THREADS;
        x[i][j] = s0 + i < n_split && e < g_count * D
                      ? __ldcg(pa + ((s0 + i) * g_count + e / D) * D + e % D)
                      : 0.f;
      }
  };
  float x[SPC][EPT];
  load_chunk(x, 0);
  // [GMAX][MAX_SPLITS] maxima, then weights; sums; 1 / total [GMAX]
  float* wts = reinterpret_cast<float*>(smem);
  float* sums = wts + GMAX * MAX_SPLITS;
  float* inv = sums + GMAX * MAX_SPLITS;
  const float* ml = part_ml + group * n_split * g_count * 2;
  for (int i = tid; i < n_split * g_count; i += THREADS) {
    const float2 p = __ldcg(reinterpret_cast<const float2*>(ml) + i);
    wts[(i % g_count) * MAX_SPLITS + i / g_count] = p.x;
    sums[(i % g_count) * MAX_SPLITS + i / g_count] = p.y;
  }
  __syncthreads();
  for (int g = warp; g < g_count; g += WARPS) {
    float* wg = wts + g * MAX_SPLITS;
    float m = NEG_INF;
    for (int sp2 = lane; sp2 < n_split; sp2 += 32) m = fmaxf(m, wg[sp2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int sp2 = lane; sp2 < n_split; sp2 += 32)
      wg[sp2] = sums[g * MAX_SPLITS + sp2] > 0.f ? expf(wg[sp2] - m) : 0.f;
    __syncwarp();
    if (lane == 0) {  // the denominator in split order
      float l = 0.f;
      for (int sp2 = 0; sp2 < n_split; ++sp2) l = fmaf(sums[g * MAX_SPLITS + sp2], wg[sp2], l);
      inv[g] = 1.f / fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  float acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = 0.f;  // an empty split wrote zeros with weight 0
  for (int s0 = 0; s0 < n_split; s0 += SPC) {  // in split order
    if (s0 > 0) load_chunk(x, s0);
#pragma unroll
    for (int i = 0; i < SPC; ++i)
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        const int e = tid + j * THREADS;
        if (s0 + i < n_split && e < g_count * D)
          acc[j] = fmaf(x[i][j], wts[(e / D) * MAX_SPLITS + s0 + i], acc[j]);
      }
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * THREADS;
    if (e < g_count * D) ob[e] = from_f<T>(acc[j] * inv[e / D]);
  }
  if (tid == 0) counters[group] = 0;  // ready for the next call
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

// Keys per split (a cluster of CL blocks, each taking a CL-th): whole block
// tiles a block, at least one, the fewest that keep the grid near one
// block per SM, and at most MAX_SPLITS splits.
int pick_split(int b, int hkv, int s_max, int tile) {
  const int groups = b * hkv;
  int clusters = sm_count() / (CL * groups);
  if (clusters < 1) clusters = 1;
  int sub = (s_max + clusters * CL - 1) / (clusters * CL);
  const int floor_sub = (s_max + MAX_SPLITS * CL - 1) / (MAX_SPLITS * CL);
  if (sub < floor_sub) sub = floor_sub;
  sub = (sub + tile - 1) / tile * tile;
  return CL * sub;
}

// keys of a block tile of the kernel for (dtype, d); 0 if it takes none
int block_tile(int dtype, int d) {
  switch (dtype * 1000 + d) {
    case 16: return Smem<float, 16>::TILE;
    case 64: return Smem<float, 64>::TILE;
    case 128: return Smem<float, 128>::TILE;
    case 1016: return Smem<__nv_bfloat16, 16>::TILE;
    case 1064: return Smem<__nv_bfloat16, 64>::TILE;
    case 1128: return Smem<__nv_bfloat16, 128>::TILE;
    default: return 0;
  }
}

}  // namespace
