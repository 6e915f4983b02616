// Kernel K5's grouped products at prefill sizes, written by hand for
// Hopper (sm_90a): the gate/up and down products of a sparse decoder
// layer's routed experts, each one persistent launch over every expert.
//
// Replaces no Pallas kernel: the JAX package has no expert layer. The
// router (moe_k5_route) and the combine (moe_k5_combine) stay Triton, and so
// do both products at decode sizes (ops/cuda/experts.py says which route a
// call takes).
//
// Computes, from the router's outputs: counts[e], the rows (token, slot
// pairs) routed to expert e; order[e * n + r], the pair index token * k +
// slot of its row r; wts[pair], the pair's routing weight.
//  moe_k5_gate_up: h[row0[e] + r] = SiLU(x[tok] @ Wg[e]) * (x[tok] @ Wu[e])
//    in f32, rounded once to x's type, with tok = order[e * n + r] / k and
//    row0[e] the rows of the experts before e (h is compact, expert by
//    expert); Wg[e] / Wu[e] are the first / last I columns of gateup[e].
//  moe_k5_down: y[pair] = (h[row0[e] + r] @ down[e]) * wts[pair] in f32,
//    rounded once, with pair = order[e * n + r].
// Numerics as the Triton products' and experts_reference's: every output
// element is one f32 sum over its depth, rounded once, in no order that
// depends on the router's atomics, so the output is the same bits on every
// call.
//
// What bounds it on this card: at a prefill's thousands of tokens the
// products, 2 * 3 * D * I operations a routed row (Mellum2: D 2304, I 896,
// 64 experts, top 8; a burst of 27,200 tokens is 2.70 TFLOP, 2.73 ms at 989
// TFLOP/s, two thirds of it gate/up), against ~0.4 GB of weights, x and
// the output moved once. The tensor cores bound it, and only wgmma reaches
// their rate.
//
// Design:
//  * A persistent grid of two-block clusters, one block an SM, walks a list
//    of 128-row x 256-column output tiles (gate/up: 128 columns of h,
//    whose 128 gate and 128 up columns are the 256 accumulator columns;
//    down: 256 columns of y). The list is derived on the device from
//    counts, in every block alike (build_tables, walk_tile;
//    ops/cuda/experts.py::tile_walk is its Python twin): row tiles expert
//    by expert, ceil(counts[e] / 128) of them, taken two at a time, none
//    for an expert with no rows; a cluster's tile q is column tile q % nt
//    of pair q / nt, its block of rank r takes the pair's r-th row tile,
//    and cluster c takes q = c, c + clusters, ... No host read, no
//    synchronise.
//  * The column tiles of one row tile are consecutive in the walk, so the
//    blocks running at once share a few row tiles: each row tile's A
//    operand (gathered rows of x, or a slice of h) comes from device memory
//    about once and from L2 for its other column tiles, and an expert's
//    weights stay in L2 across its adjacent row tiles.
//  * The two blocks of a cluster compute the same expert's adjacent row
//    tiles at one column tile and in step, so they share each weight tile:
//    each loads half of it by TMA and multicasts it to both, which halves
//    the weights' traffic from L2 (the operands' traffic from L2, not the
//    tensor cores, set the time of a block alone). The second tile of an
//    expert's odd last pair has no rows; its block loads and multiplies
//    zeros and writes nothing.
//  * A producer warpgroup fills a ring of 64-deep operand stages on
//    mbarriers (4 in gate/up, 3 in down); two consumer warpgroups of 64
//    rows each run wgmma m64n256k16 on them (A K-major, B MN-major: gateup
//    (E, D, 2I) and down (E, I, D) are read as they are stored, through
//    wgmma's transposed-B operand, so nothing is re-laid out) and free
//    each stage in both blocks once their products are done. The producer
//    runs on into the next tile, so its loads overlap this tile's
//    epilogue.
//  * gate/up's A is a gather (TMA cannot gather rows): the 128 producer
//    threads copy their rows' 16-byte chunks of x through order with
//    cp.async, whose completion arrives on the stage's barrier without the
//    producer waiting; the consumers fence the rows to the async proxy
//    before wgmma reads them. down's A is a contiguous slice of h, one TMA
//    box; rows past the expert's are computed and not written.
//  * Epilogues: gate/up's SiLU(g) * u is rounded and stored from registers;
//    down's rows, scaled by their weights (read while the products run)
//    and rounded, go to shared memory and out by one bulk copy a row to
//    their pairs' rows of y (for the combine), which runs under the next
//    tile's products.
//  * Widths: D % 256 == 0, I % 128 == 0, at most 256 experts; the wrapper
//    checks them.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;  // accumulator columns a tile
constexpr int BK = 64;   // depth a stage
constexpr int THREADS = 384;  // a producer warpgroup, two consumers
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;  // four 64 x 64 boxes
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int MAX_E = 256;
// down's output rows pass through shared memory on their way to bulk
// stores, 16 bytes of padding a row keeping a warp's writes on distinct
// banks
constexpr int STG_ROW = BN * 2 + 16;

// Shared memory of a product: a ring of STAGES operand stages, full[s] /
// empty[s] barriers (16 bytes a stage) and, for down, the staged rows,
// which cost it a stage
template <bool GATE_UP>
struct Cfg {
  static constexpr int STAGES = GATE_UP ? 4 : 3;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int STG = BARS + STAGES * 16;
  static constexpr int SMEM = 1024 + STG + (GATE_UP ? 0 : BM * STG_ROW);
  static_assert(SMEM + 2 * (MAX_E + 1) * 4 <= 227 * 1024, "tiles exceed shared memory");
};

// wgmma m64n256k16, f32 += T * T, A K-major and B MN-major from shared
// memory; scale_d = 0 overwrites the accumulators (a tile's first step)
template <typename T>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_n256<bf16>(float (&d)[128], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_n256<__half>(float (&d)[128], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// SiLU in f32 on the fast exponential and division (a few ulp of f32, as
// Triton's tl.exp and division): the epilogue's many exponentials would
// otherwise cost as much as a tenth of a tile's products
__device__ __forceinline__ float silu(float g) { return __fdividef(g, 1.f + __expf(-g)); }

// Clusters of two blocks (the CTA pair of one TPC): the two compute
// vertically adjacent row tiles of one expert at the same column tile, so
// they share the weight tile, which each loads half of and multicasts to
// both; each gathers or loads its own rows.
constexpr int PAIR = 2;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of the cluster arrives, then waits for the others (release /
// acquire: shared-memory writes before it are seen after it, cluster-wide)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// an arrival on the barrier at the same offset in block `rank`'s shared
// memory
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank) : "memory");
}
// tma_load into the same offset of both blocks' shared memory, completing
// on the barrier at the same offset in each
__device__ __forceinline__ void tma_load_pair(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"((uint16_t)((1 << PAIR) - 1))
      : "memory");
}

// The cp.async copies this thread has issued arrive on the barrier once
// they land, as one of its expected arrivals; the thread goes on at once.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// bulk copy of `bytes` (a multiple of 16) from shared to device memory, in
// this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 128 threads of one warpgroup meet at named barrier `id`
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// One block's tile: expert e, its rows m0.. (rows of them in all; none
// where m0 >= rows: the second of an expert's odd last pair), the expert's
// first compact row, and the column tile.
struct Tile {
  int e, m0, rows, start, col;
};

// Tile q of a cluster's walk, for the block of cluster rank `rank`: column
// tile q % nt of the pair of row tiles q / nt, of which the block takes the
// rank-th. pair0[e] is expert e's first pair (each expert has ceil(ceil(
// counts[e] / BM) / 2) pairs), row0[e] its first compact row (entry E
// closes both). `e` is the caller's cursor: it only moves forward, as a
// cluster's q do.
__device__ __forceinline__ Tile walk_tile(int q, int nt, int rank, int& e, const int* pair0,
                                          const int* row0) {
  const int pr = q / nt;
  while (pair0[e + 1] <= pr) ++e;
  return Tile{e, (PAIR * (pr - pair0[e]) + rank) * BM, row0[e + 1] - row0[e], row0[e], q % nt};
}

// Warp 0 builds pair0 / row0 from counts (each lane a run of experts, a
// scan across the lanes); with stats, adds the routed rows and the busiest
// expert's rows to it (int64).
__device__ __forceinline__ void build_tables(const int* __restrict__ counts, int e_count,
                                             int* pair0, int* row0, long long* stats) {
  const int lane = threadIdx.x % 32, per = (e_count + 31) / 32;
  int c[MAX_E / 32];
  int rows = 0, pairs = 0, most = 0;
#pragma unroll
  for (int i = 0; i < MAX_E / 32; ++i) {
    const int j = lane * per + i;
    c[i] = i < per && j < e_count ? counts[j] : 0;
    rows += c[i];
    pairs += ((c[i] + BM - 1) / BM + PAIR - 1) / PAIR;
    most = max(most, c[i]);
  }
  int rows_in = rows, pairs_in = pairs;  // inclusive over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int r = __shfl_up_sync(~0u, rows_in, o), p = __shfl_up_sync(~0u, pairs_in, o);
    if (lane >= o) {
      rows_in += r;
      pairs_in += p;
    }
  }
  int r = rows_in - rows, p = pairs_in - pairs;
#pragma unroll
  for (int i = 0; i < MAX_E / 32; ++i) {
    const int j = lane * per + i;
    if (i < per && j < e_count) {
      row0[j] = r;
      pair0[j] = p;
      r += c[i];
      p += ((c[i] + BM - 1) / BM + PAIR - 1) / PAIR;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) most = max(most, __shfl_xor_sync(~0u, most, o));
  if (lane == 31) {
    row0[e_count] = rows_in;
    pair0[e_count] = pairs_in;
    if (stats != nullptr) {
      atomicAdd(reinterpret_cast<unsigned long long*>(stats), (unsigned long long)rows_in);
      atomicAdd(reinterpret_cast<unsigned long long*>(stats) + 1, (unsigned long long)most);
    }
  }
}

// The persistent grouped product. GATE_UP: A gathered from x (n, d), B
// map_b over gateup as (E * d, 2 inter), out = h (n * k, inter). Down: A
// map_a over h (n * k, inter), B map_b over down as (E * inter, d), out =
// y (n * k, d).
template <typename T, bool GATE_UP>
__device__ __forceinline__ void grouped(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        const T* __restrict__ x, const int* __restrict__ counts,
                                        const int* __restrict__ order,
                                        const float* __restrict__ wts, T* __restrict__ out,
                                        long long* stats, int n, int d, int inter, int e_count,
                                        int k) {
  using C = Cfg<GATE_UP>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem[];
  __shared__ int pair0[MAX_E + 1], row0[MAX_E + 1];
  const uint32_t base = smem_base(smem), bars = base + C::BARS, stg = base + C::STG;
  auto full = [&](int s) { return bars + 16 * s; };
  auto empty = [&](int s) { return bars + 16 * s + 8; };
  const int tid = threadIdx.x, wg = tid / 128;
  const int rank = cluster_rank(), cluster = blockIdx.x / PAIR, clusters = gridDim.x / PAIR;
  const int nt = GATE_UP ? inter / (BN / 2) : d / BN;  // column tiles a row tile
  const int ktiles = (GATE_UP ? d : inter) / BK;
  if (tid < 32) build_tables(counts, e_count, pair0, row0, blockIdx.x == 0 ? stats : nullptr);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // gate/up: an arrival per producer thread (its gathered rows) and the
      // TMA's expect_tx; down: the TMA's alone
      mbar_init(full(s), GATE_UP ? 129 : 1);
      // an arrival per consumer warpgroup of both blocks: a stage is
      // refilled in both at once
      mbar_init(empty(s), 2 * PAIR);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  const int total = pair0[e_count] * nt;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    int e = 0, it = 0;
    if (GATE_UP) {
      // thread tid copies 16-byte chunk tid % 8 of tile rows tid / 8 + 16 i
      const int c = tid % 8, r0 = tid / 8;
      for (int q = cluster; q < total; q += clusters) {
        const Tile tl = walk_tile(q, nt, rank, e, pair0, row0);
        const int* ord = order + (size_t)tl.e * n + tl.m0;
        int tok[8];  // -1: past the expert's rows, zero-filled
#pragma unroll
        for (int i = 0; i < 8; ++i)
          tok[i] = tl.m0 + r0 + 16 * i < tl.rows ? ord[r0 + 16 * i] / k : -1;
        // this block's half of the weight tile: rank 0 the gate columns
        // (boxes 0-1), rank 1 the up columns (boxes 2-3)
        const int wrow = tl.e * d, wcol = rank * inter + tl.col * (BN / 2);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
          const uint32_t a_dst = base + s * STAGE, b_dst = a_dst + A_BYTES;
          if (tid == 0) {
            mbar_expect_tx(full(s), B_BYTES);
            for (int j = 0; j < 2; ++j)
              tma_load_pair(b_dst + (2 * rank + j) * BK * 128, map_b, wcol + 64 * j,
                            wrow + kt * BK, full(s));
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            cp_async16(a_dst + swz(r0 + 16 * i, c),
                       x + (size_t)(tok[i] < 0 ? 0 : tok[i]) * d + kt * BK + 8 * c, tok[i] >= 0);
          cp_async_arrive(full(s));
        }
      }
    } else if (tid == 0) {
      for (int q = cluster; q < total; q += clusters) {
        const Tile tl = walk_tile(q, nt, rank, e, pair0, row0);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
          const uint32_t a_dst = base + s * STAGE, b_dst = a_dst + A_BYTES;
          mbar_expect_tx(full(s), STAGE);
          tma_load(a_dst, map_a, kt * BK, tl.start + tl.m0, full(s));
          // this block's half of the weight tile: boxes 2 rank, 2 rank + 1
          for (int j = 2 * rank; j < 2 * rank + 2; ++j)
            tma_load_pair(b_dst + j * BK * 128, map_b, tl.col * BN + 64 * j,
                          tl.e * inter + kt * BK, full(s));
        }
      }
    }
  } else {
    // consumers: warpgroup 1 takes rows 0-63 of a tile, 2 rows 64-127
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int cw = wg - 1, wt = tid % 128, warp = wt / 32, lane = tid % 32, quad = lane % 4;
    const int row_in = 64 * cw + 16 * warp + lane / 4;  // this thread's rows: row_in, + 8
    // a stage is free once the consumers of both blocks are done with it
    auto release = [&](int s) {
      if (wt == 0)
        for (int b = 0; b < PAIR; ++b) mbar_arrive_remote(empty(s), b);
    };
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int e = 0, it = 0;
    for (int q = cluster; q < total; q += clusters) {
      const Tile tl = walk_tile(q, nt, rank, e, pair0, row0);
      // down's epilogue reads: each of this thread's rows' weight, and the
      // pair of the row it stores, loaded now so the products hide them
      float w[2] = {0.f, 0.f};
      int my_pair = 0;
      if (!GATE_UP) {
        const int* ord = order + (size_t)tl.e * n + tl.m0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (tl.m0 + row_in + 8 * h < tl.rows) w[h] = wts[ord[row_in + 8 * h]];
        if (wt < 64 && tl.m0 + 64 * cw + wt < tl.rows) my_pair = ord[64 * cw + wt];
      }
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        // the gathered rows landed through the generic proxy: order them
        // before wgmma's reads
        if (GATE_UP) fence_async_smem();
        const uint32_t a_addr = base + s * STAGE + cw * 64 * 128;
        const uint32_t b_addr = base + s * STAGE + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_n256<T>(acc, desc_sw128(a_addr + ks * 32, 16),
                        desc_sw128(b_addr + ks * 2048, BK * 128), kt > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: free it
        if (kt > 0) release((it - 1) % STAGES);
      }
      wgmma_wait<0>();
      release((it - 1) % STAGES);
      fence_regs(acc);
      // accumulator register 4 j + 2 h + i: row row_in + 8 h, column 8 j +
      // 2 quad + i (gate/up: gate columns j < 16, up columns j >= 16)
      if (GATE_UP) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tl.m0 + row_in + 8 * h;
          if (r >= tl.rows) continue;
          T* dst = out + (size_t)(tl.start + r) * inter + tl.col * (BN / 2) + 2 * quad;
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            const float* g = acc + 4 * j + 2 * h;
            const float* u = g + BN / 4;
            *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                pack2<T>(silu(g[0]) * u[0], silu(g[1]) * u[1]);
          }
        }
      } else {
        // this warpgroup's 64 rows, scaled and rounded, to the staging rows
        // (once the last tile's stores have read them), then one bulk store
        // a row to its pair's row of y, issued by threads 0-63, which the
        // next tile's products overlap
        if (wt < 64) bulk_wait<true>();
        warpgroup_sync(1 + cw);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t row = stg + (row_in + 8 * h) * STG_ROW + 4 * quad;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(row + 16 * j),
                         "r"(pack2<T>(acc[4 * j + 2 * h] * w[h], acc[4 * j + 2 * h + 1] * w[h]))
                         : "memory");
        }
        fence_async_smem();
        warpgroup_sync(1 + cw);
        if (wt < 64) {
          if (tl.m0 + 64 * cw + wt < tl.rows)
            bulk_store(out + (size_t)my_pair * d + tl.col * BN, stg + (64 * cw + wt) * STG_ROW,
                       BN * 2);
          bulk_commit();
        }
      }
    }
    if (!GATE_UP && wt < 64) bulk_wait<false>();
  }
  // no block leaves while its partner may still write to its shared memory
  cluster_sync();
}

template <typename T>
__global__ void __cluster_dims__(PAIR, 1, 1) __launch_bounds__(THREADS, 1)
moe_k5_gate_up(const __grid_constant__ CUtensorMap map_w, const T* __restrict__ x,
               const int* __restrict__ counts, const int* __restrict__ order,
               T* __restrict__ h, long long* stats, int n, int d, int inter, int e_count,
               int k) {
  grouped<T, true>(nullptr, &map_w, x, counts, order, nullptr, h, stats, n, d, inter, e_count,
                   k);
}

template <typename T>
__global__ void __cluster_dims__(PAIR, 1, 1) __launch_bounds__(THREADS, 1)
moe_k5_down(const __grid_constant__ CUtensorMap map_h, const __grid_constant__ CUtensorMap map_w,
            const int* __restrict__ counts, const int* __restrict__ order,
            const float* __restrict__ wts, T* __restrict__ y, int n, int d, int inter,
            int e_count) {
  grouped<T, false>(&map_h, &map_w, nullptr, counts, order, wts, y, nullptr, n, d, inter,
                    e_count, 1);
}

// the clusters of `kernel` that fit on the card at once (cached per kernel)
template <typename K>
int max_clusters(K kernel, int smem) {
  static int count = 0;
  if (count == 0) {
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = PAIR;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.gridDim = dim3(sm_count() / PAIR * PAIR);
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = smem;
    config.attrs = &attr;
    config.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&count, kernel, &config) != cudaSuccess || count <= 0) {
      cudaGetLastError();
      count = sm_count() / PAIR;
    }
  }
  return count;
}

template <typename T>
cudaError_t launch(const void* x, const void* gateup, const void* down, const int* counts,
                   const int* order, const float* wts, void* h, void* y, long long* stats, int n,
                   int d, int inter, int e, int k, CUtensorMapDataType type,
                   cudaStream_t stream) {
  static const cudaError_t attr = [] {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_k5_gate_up<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<true>::SMEM);
    return err != cudaSuccess ? err
                              : cudaFuncSetAttribute(moe_k5_down<T>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     Cfg<false>::SMEM);
  }();
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_gu, map_h, map_dn;
  cudaError_t err = tensor_map(&map_gu, gateup, e * d, 2 * inter, BK, type);
  if (err == cudaSuccess) err = tensor_map(&map_h, h, n * k, inter, BM, type);
  if (err == cudaSuccess) err = tensor_map(&map_dn, down, e * inter, d, BK, type);
  if (err != cudaSuccess) return err;
  // pairs of row tiles: at most the rows' own tiles, one ragged tile an
  // expert and one lone tile an expert, two to a pair
  const int pairs = ((n * k + BM - 1) / BM + 2 * e + 1) / PAIR;
  const auto least = [](int a, int b) { return a < b ? a : b; };
  const int gu =
      least(pairs * (inter / (BN / 2)), max_clusters(moe_k5_gate_up<T>, Cfg<true>::SMEM));
  const int dn = least(pairs * (d / BN), max_clusters(moe_k5_down<T>, Cfg<false>::SMEM));
  moe_k5_gate_up<T><<<PAIR * gu, THREADS, Cfg<true>::SMEM, stream>>>(
      map_gu, (const T*)x, counts, order, (T*)h, stats, n, d, inter, e, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_k5_down<T><<<PAIR * dn, THREADS, Cfg<false>::SMEM, stream>>>(
      map_h, map_dn, counts, order, wts, (T*)y, n, d, inter, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fvlm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (n, d); gateup: (e, d, 2 inter), each expert's gate columns then its
// up columns; down: (e, inter, d); counts: (e,) int32, the rows routed to
// each expert; order: (e * n,) int32, expert j's pair indices (token * k +
// slot) at order[j * n ...]; wts: (n * k,) f32, each pair's weight; h: (n *
// k, inter), scratch; y: (n * k, d), each routed pair's weighted row (the
// others are not written); stats: null, or an int64 pair to which the
// gate/up launch adds the routed rows and the busiest expert's. dtype: 1
// bfloat16, 2 float16; d % 256 == 0, inter % 128 == 0, 1 <= e <= 256;
// every pointer 16-byte aligned. Two launches on `stream`; returns the CUDA
// error code.
int fvlm_moe_k5_grouped(const void* x, const void* gateup, const void* down, const int* counts,
                        const int* order, const float* wts, void* h, void* y, long long* stats,
                        int n, int d, int inter, int e, int k, int dtype, cudaStream_t stream) {
  if (n < 1 || k < 1 || e < 1 || e > MAX_E || d % BN != 0 || inter % (BN / 2) != 0)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 1:
      return launch<bf16>(x, gateup, down, counts, order, wts, h, y, stats, n, d, inter, e, k,
                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, stream);
    case 2:
      return launch<__half>(x, gateup, down, counts, order, wts, h, y, stats, n, d, inter, e, k,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT16, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
